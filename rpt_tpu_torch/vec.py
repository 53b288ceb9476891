"""Structure-of-arrays 3-vector math on torch tensors.

Port of `rpt_tpu/vec.py`: each component is its own flat ``(N,)`` tensor,
so every vector op is one element-wise torch op. ``Vec3``, ``Mat3`` and
``Affine`` hold tensors (0-dim for constants, ``(N,)`` for batches) that
broadcast against each other as torch does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .dtypes import DTYPE


def _t(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=DTYPE, device=device)


@dataclass(frozen=True)
class Vec3:
    """A 3-vector (or batch of 3-vectors) stored as separate components."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # ---- constructors -------------------------------------------------
    @staticmethod
    def of(x, y, z, device=None) -> "Vec3":
        return Vec3(_t(x, device), _t(y, device), _t(z, device))

    @staticmethod
    def full(value, shape=(), device=None) -> "Vec3":
        v = torch.full(tuple(shape) if not isinstance(shape, int) else (shape,),
                       float(value), dtype=DTYPE, device=device)
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape=(), device=None) -> "Vec3":
        return Vec3.full(0.0, shape, device)

    @staticmethod
    def ones(shape=(), device=None) -> "Vec3":
        return Vec3.full(1.0, shape, device)

    @staticmethod
    def from_array(a, device=None) -> "Vec3":
        """From an (..., 3) array (API boundary only)."""
        a = _t(np.asarray(a) if not isinstance(a, torch.Tensor) else a, device)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z), dim=-1)

    def to_numpy(self) -> np.ndarray:
        return self.to_array().cpu().numpy()

    # ---- shape helpers -------------------------------------------------
    @property
    def shape(self):
        return torch.broadcast_shapes(self.x.shape, self.y.shape, self.z.shape)

    @property
    def device(self):
        return self.x.device

    def broadcast_to(self, shape) -> "Vec3":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return Vec3(self.x.expand(shape), self.y.expand(shape), self.z.expand(shape))

    def reshape(self, *shape) -> "Vec3":
        return self.map(lambda c: c.reshape(*shape))

    def __getitem__(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    def map(self, f) -> "Vec3":
        return Vec3(f(self.x), f(self.y), f(self.z))

    # ---- arithmetic ----------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        """Scalar broadcast, or component-wise (Hadamard) product."""
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # ---- geometry ------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.length_squared())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        inv = torch.rsqrt(torch.clamp(self.length_squared(), min=eps if eps else 1e-38))
        return self * inv

    def abs(self) -> "Vec3":
        return self.map(torch.abs)

    def sum(self) -> torch.Tensor:
        return self.x + self.y + self.z

    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def min_component(self) -> torch.Tensor:
        return torch.minimum(self.x, torch.minimum(self.y, self.z))

    def minimum(self, o: "Vec3") -> "Vec3":
        return Vec3(torch.minimum(self.x, o.x), torch.minimum(self.y, o.y),
                    torch.minimum(self.z, o.z))

    def maximum(self, o: "Vec3") -> "Vec3":
        return Vec3(torch.maximum(self.x, o.x), torch.maximum(self.y, o.y),
                    torch.maximum(self.z, o.z))

    def isfinite(self) -> torch.Tensor:
        return torch.isfinite(self.x) & torch.isfinite(self.y) & torch.isfinite(self.z)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise select: ``mask ? a : b``."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    """glm::mix — linear interpolation (the HDRI's bilinear sample,
    `environment.rs:39-51`)."""
    return a + (b - a) * t


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """glm::reflect_vec(v, n) = v - 2*(v.n)*n."""
    return v - n * (2.0 * v.dot(n))


def take(v: Vec3, idx) -> Vec3:
    """Gather: v[idx] for integer index tensors."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def orthonormal_basis(n: Vec3):
    """Branchless orthonormal basis around unit vector ``n`` (Duff et al.
    2017), as `rpt_tpu/vec.py:200`: returns ``(t, b)`` with ``(t, n, b)``
    right-handed orthonormal."""
    one = torch.ones_like(n.z)
    sign = torch.where(n.z >= 0.0, one, -one)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    u = Vec3(b, sign + n.y * n.y * a, -n.y)
    return t, u


def from_local(local: Vec3, n: Vec3) -> Vec3:
    """Map a local-frame direction (y-up) into the frame of normal ``n``."""
    t, b = orthonormal_basis(n)
    return t * local.x + n * local.y + b * local.z


# Affine transforms -------------------------------------------------------


@dataclass(frozen=True)
class Mat3:
    """Row-major 3x3 matrix with tensor entries (batched like Vec3)."""

    m00: torch.Tensor
    m01: torch.Tensor
    m02: torch.Tensor
    m10: torch.Tensor
    m11: torch.Tensor
    m12: torch.Tensor
    m20: torch.Tensor
    m21: torch.Tensor
    m22: torch.Tensor

    @staticmethod
    def from_numpy(m, device=None) -> "Mat3":
        m = np.asarray(m)
        return Mat3(*[_t(m[..., i, j], device) for i in range(3) for j in range(3)])

    def apply(self, v: Vec3) -> Vec3:
        return Vec3(
            self.m00 * v.x + self.m01 * v.y + self.m02 * v.z,
            self.m10 * v.x + self.m11 * v.y + self.m12 * v.z,
            self.m20 * v.x + self.m21 * v.y + self.m22 * v.z,
        )

    def __getitem__(self, idx) -> "Mat3":
        return Mat3(*[getattr(self, f)[idx] for f in _MAT3_FIELDS])


_MAT3_FIELDS = [f.name for f in dataclasses.fields(Mat3)]


@dataclass(frozen=True)
class Affine:
    """Affine transform: linear 3x3 + translation, batched like Vec3."""

    linear: Mat3
    translation: Vec3

    @staticmethod
    def from_numpy(m4, device=None) -> "Affine":
        """From a (..., 4, 4) homogeneous matrix."""
        m4 = np.asarray(m4)
        return Affine(
            Mat3.from_numpy(m4[..., :3, :3], device),
            Vec3.from_array(m4[..., :3, 3], device),
        )

    def apply_point(self, p: Vec3) -> Vec3:
        return self.linear.apply(p) + self.translation

    def apply_dir(self, d: Vec3) -> Vec3:
        return self.linear.apply(d)

    def __getitem__(self, idx) -> "Affine":
        return Affine(self.linear[idx], self.translation[idx])
