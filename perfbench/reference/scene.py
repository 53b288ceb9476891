"""The plain reference's scene: a scene description (`perfbench.scenes`)
lowered to plain torch tensors in one floating-point type, with nothing
taken from the port.

Triangles are baked to world space (vertices by the forward matrix,
normals by its inverse transpose) and grouped, in the Morton order of
their centroids, into clusters of `CLUSTER` with a bounding box each: a
query tests every cluster box, then every triangle of the clusters it
enters, so the answer is the exact closest triangle by the same algebra
as `shape/mesh.rs:50-83`. Cubes and planes are tested one by one in
object space (`shape/cube.rs:22-74`, `shape/plane.rs:17-32`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLUSTER = 64  # triangles a cluster
SRGB_GAMMA = 2.2  # color.rs:10-15
TAN = 0xD2B48C  # the homogeneous isotropic medium's colour (medium.rs:80-96)
LAMBERTIAN, PHONG = 0, 1


def linear_color(c) -> tuple:
    """A hex sRGB colour as linear floats (as float32 values), or linear
    floats as they are."""
    if isinstance(c, int):
        rgb = (((c >> 16) & 0xFF) / 255.0, ((c >> 8) & 0xFF) / 255.0, (c & 0xFF) / 255.0)
        return tuple(float(np.float32(v**SRGB_GAMMA)) for v in rgb)
    return tuple(float(v) for v in c)


def matrix(steps) -> np.ndarray:
    """The forward 4x4 matrix of transform steps applied in order (each
    step multiplies from the left, shape.rs:180-231)."""
    m = np.eye(4)
    for op, arg in steps:
        s = np.eye(4)
        if op == "scale":
            s[0, 0], s[1, 1], s[2, 2] = arg
        elif op == "translate":
            s[:3, 3] = arg
        elif op == "rotate_y":
            c, si = math.cos(arg), math.sin(arg)
            s[:3, :3] = [[c, 0.0, si], [0.0, 1.0, 0.0], [-si, 0.0, c]]
        else:
            raise ValueError(f"unknown transform step {op!r}")
        m = s @ m
    return m


def _flat_normals(v: np.ndarray) -> np.ndarray:
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(norm == 0.0, 1.0, norm)
    return np.repeat(n[:, None, :], 3, axis=1)


def _morton_order(points: np.ndarray) -> np.ndarray:
    lo, hi = points.min(0), points.max(0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-30) * 1023.0).astype(np.uint64)

    def spread(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        return (x | (x << np.uint64(2))) & np.uint64(0x09249249)

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


class RefScene:
    """Tensors of one scene on ``device`` in ``dtype`` (float32 for the
    reference; bfloat16 for its lower-precision control)."""

    def __init__(self, desc: dict, device, dtype=torch.float32):
        self.device, self.dtype = device, dtype
        self.width, self.height = desc["width"], desc["height"]
        self.max_bounces, self.media_depth = desc["max_bounces"], desc["media_max_depth"]
        self.exposure = 2.0 ** desc["exposure_value"]
        self._materials = []
        tris, tri_mat, cubes, planes, corners = [], [], [], [], []
        lights = []
        for o in desc["objects"]:
            mid = self._material(o["material"])
            if o["shape"] == "mesh":
                m4 = matrix(o["transform"])
                v = o["vertices"] @ m4[:3, :3].T + m4[:3, 3]
                raw_n = o["normals"] if o["normals"] is not None else _flat_normals(o["vertices"])
                n = raw_n @ np.linalg.inv(m4[:3, :3])
                tris.append((v, n))
                tri_mat.append(np.full(len(v), mid))
                corners.append(v.reshape(-1, 3))
                if o.get("light"):
                    lights.append(self._mesh_light(v, n, o["material"]))
            elif o["shape"] == "cube":
                m4 = matrix(o["transform"])
                cubes.append((m4, mid))
                c = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)])
                corners.append(c @ m4[:3, :3].T + m4[:3, 3])
            elif o["shape"] == "plane":
                planes.append((np.asarray(o["normal"], np.float64), float(o["value"]), mid))
            else:
                raise NotImplementedError(f"the reference has no {o['shape']!r} object")
        for light in desc["lights"]:
            if light["kind"] == "ambient":
                lights.append({"kind": "ambient", "color": self._t(light["color"])})
            elif light["shape"] == "sphere":
                m4 = matrix(light["transform"])
                lin = m4[:3, :3]
                lights.append({"kind": "sphere", "fwd": self._t(m4[:3]),
                               "inv": self._t(np.linalg.inv(m4)[:3]),
                               "nmat": self._t(np.linalg.inv(lin).T),
                               "det": float(np.float32(np.linalg.det(lin))),
                               "emit": self._emit(light["material"]),
                               "color": self._t(linear_color(light["material"]["color"]))})
            else:
                raise NotImplementedError(f"the reference has no {light['shape']!r} light")
        self.lights = lights
        pts = np.concatenate(corners)
        self.scale = max(float(np.linalg.norm(pts.max(0) - pts.min(0))), 1e-6)
        self.t_min = 2e-4 * self.scale  # the renderer's scale-aware epsilon
        self.shadow_eps = 1e-3
        self._triangles(tris, tri_mat)
        self.cubes = [(self._t(np.linalg.inv(m4)[:3]),
                       self._t(np.linalg.inv(m4[:3, :3]).T), mid) for m4, mid in cubes]
        self.planes = [(self._t(n), float(np.float32(v)), mid) for n, v, mid in planes]
        mats = self._materials
        self.mat_kind = torch.tensor([m[0] for m in mats], device=device)
        self.mat_albedo = self._t([m[1] for m in mats])
        self.mat_emit = self._t([m[2] for m in mats])
        self.mat_shine = self._t([m[3] for m in mats])
        med = desc["medium"]
        self.medium = None
        if med is not None:
            if med["kind"] != "homogeneous_isotropic":
                raise NotImplementedError(med["kind"])
            self.medium = {"absorption": med["absorption"], "scattering": med["scattering"],
                           "color": self._t(linear_color(TAN))}
        self._camera(desc["camera"])

    # -- construction ------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        """float64 data rounded to float32, then held in the scene's type."""
        return torch.tensor(np.asarray(a, np.float64), dtype=torch.float32,
                            device=self.device).to(self.dtype)

    def _material(self, m: dict) -> int:
        kinds = {"diffuse": LAMBERTIAN, "light": LAMBERTIAN, "specular": PHONG}
        if m["kind"] not in kinds:
            raise NotImplementedError(f"the reference has no {m['kind']!r} material")
        kind = kinds[m["kind"]]
        row = (kind, linear_color(m["color"]), float(m.get("emittance", 0.0)),
               float(m.get("roughness", 0.0)))
        if row not in self._materials:
            self._materials.append(row)
        return self._materials.index(row)

    def _emit(self, m: dict) -> torch.Tensor:
        return self._t(linear_color(m["color"])) * float(m["emittance"])

    def _mesh_light(self, v, n, material) -> dict:
        area = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
        return {"kind": "mesh", "v": [self._t(v[:, i]) for i in range(3)],
                "n": [self._t(n[:, i]) for i in range(3)], "area": self._t(area),
                "count": len(v), "emit": self._emit(material),
                "color": self._t(linear_color(material["color"]))}

    def _triangles(self, tris, tri_mat):
        dev = self.device
        if not tris:
            self.n_tris = 0
            return
        v = np.concatenate([t[0] for t in tris])
        n = np.concatenate([t[1] for t in tris])
        self.n_tris = len(v)
        self.tri_v1 = self._t(v[:, 0])
        self.tri_e1 = self._t(v[:, 1] - v[:, 0])
        self.tri_e2 = self._t(v[:, 2] - v[:, 0])
        self.tri_pn = normalize(cross(self.tri_e1, self.tri_e2))
        self.tri_n = [self._t(n[:, i]) for i in range(3)]
        self.tri_mat = torch.tensor(np.concatenate(tri_mat), device=dev)
        order = _morton_order(v.mean(1))
        pad = (-len(order)) % CLUSTER
        members = np.concatenate([order, np.full(pad, -1)]).reshape(-1, CLUSTER)
        safe = np.where(members < 0, members[:, :1], members)
        lo = v[safe].reshape(len(members), -1, 3).min(1)
        hi = v[safe].reshape(len(members), -1, 3).max(1)
        slack = 1e-4 * self.scale  # boxes only cull: widen them past any rounding
        self.cl_members = torch.tensor(members, device=dev)
        self.cl_lo = torch.tensor(lo - slack, dtype=torch.float32, device=dev)
        self.cl_hi = torch.tensor(hi + slack, dtype=torch.float32, device=dev)

    def _camera(self, cam: dict):
        if "look_at" in cam:
            la = cam["look_at"]
            eye = np.asarray(la["eye"], np.float64)
            fwd = np.asarray(la["center"], np.float64) - eye
            fwd = fwd / np.linalg.norm(fwd)
            up = np.asarray(la["up"], np.float64)
            up = up - np.dot(up, fwd) * fwd
            up = up / np.linalg.norm(up)
            fov = la["fov"]
        else:
            eye = np.asarray(cam["eye"], np.float64)
            fwd = np.asarray(cam["direction"], np.float64)
            fwd = fwd / np.linalg.norm(fwd)
            up = np.asarray(cam["up"], np.float64)
            fov = cam["fov"]
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        self.cam_eye, self.cam_fwd = self._t(eye), self._t(fwd)
        self.cam_up, self.cam_right = self._t(up), self._t(right)
        self.cam_d = 1.0 / math.tan(fov / 2.0)


# -- vector helpers on (n, 3) tensors ----------------------------------------
def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v), min=1e-38))[..., None]


def apply(m, p, point: bool = True):
    """A (3, 4) affine map (or a (3, 3) linear one) applied to (n, 3)
    points, row by row in the order m0*x + m1*y + m2*z (+ t)."""
    out = [m[r, 0] * p[:, 0] + m[r, 1] * p[:, 1] + m[r, 2] * p[:, 2] for r in range(3)]
    if point:
        out = [out[r] + m[r, 3] for r in range(3)]
    return torch.stack(out, dim=-1)
