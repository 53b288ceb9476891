"""Rays and hit records (SoA batches) — port of `rpt_tpu/ray.py`.

A ``Ray`` is an origin plus a unit direction; a ``Hit`` starts at
time=inf and is only improved by closer hits (`shape.rs:48-98`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .dtypes import DTYPE, INF
from .vec import Affine, Vec3, where


@dataclass(frozen=True)
class Ray:
    origin: Vec3
    dir: Vec3

    def at(self, t) -> Vec3:
        """Evaluate the ray at parameter t (shape.rs:60-62), each component
        rounded once (as a fused multiply-add): the product of two f32
        values is exact in f64."""
        def fma(o, d):
            return (o.double() + d.double() * t.double()).to(o.dtype)
        return Vec3(fma(self.origin.x, self.dir.x), fma(self.origin.y, self.dir.y),
                    fma(self.origin.z, self.dir.z))

    def transform(self, a: Affine) -> "Ray":
        """Apply an affine transform without normalizing the direction
        (shape.rs:65-72), so t is preserved across object/world space."""
        return Ray(a.apply_point(self.origin), a.apply_dir(self.dir))


@dataclass(frozen=True)
class Hit:
    """Batched hit record: time (inf = miss), shading normal, material id
    (int32 row of the material table; -1 where there is no hit)."""

    time: torch.Tensor
    normal: Vec3
    material: torch.Tensor

    @staticmethod
    def none(shape, device=None) -> "Hit":
        return Hit(
            torch.full(shape, INF, dtype=DTYPE, device=device),
            Vec3.zeros(shape, device),
            torch.full(shape, -1, dtype=torch.int32, device=device),
        )

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.time)


def aabb_interval(ray: Ray, p_min: Vec3, p_max: Vec3):
    """The ray's parameter interval inside the box [p_min, p_max], NaN-safe
    as the slab test of kdtree.rs:57-71: an axis whose 0*inf gives NaN
    does not constrain. Returns ``(enter, exit)``."""
    inv = ray.dir.map(torch.reciprocal)
    t1 = (p_min - ray.origin) * inv
    t2 = (p_max - ray.origin) * inv
    lo = t1.minimum(t2).map(lambda c: torch.where(torch.isnan(c), -INF, c))
    hi = t1.maximum(t2).map(lambda c: torch.where(torch.isnan(c), INF, c))
    return lo.max_component(), hi.min_component()


def closer(a: Hit, b: Hit) -> Hit:
    """Keep the closer hit per lane (shape.rs:20-22)."""
    take_b = b.time < a.time
    return Hit(
        torch.where(take_b, b.time, a.time),
        where(take_b, b.normal, a.normal),
        torch.where(take_b, b.material, a.material),
    )
