"""Lights and their sampling — port of `rpt_tpu/lights.py`
(`rpt/src/light.rs`).

Four kinds — Point, Ambient, Directional, and Object (invisible emissive
geometry). ``illuminate`` returns (intensity, dir_to_light, dist_to_light)
per ray lane. Object-light shape sampling ports the per-shape ``sample``
methods (`shape/sphere.rs:53-65`, `shape/cube.rs:76-89`,
`shape/mesh.rs:85-99`, `kdtree.rs:141-147`) and the ``Transformed`` pdf
correction (shape.rs:140-151).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import sampling
from .dtypes import DTYPE, INF
from .materials import Material
from .shapes import Cube, Mesh, MonomialSurface, Sphere, Transformed, transform_mesh, unwrap
from .vec import Affine, Mat3, Vec3, take, where


# ---------------------------------------------------------------------------
# Host-side light descriptions


@dataclass(frozen=True)
class PointLight:
    color: tuple
    position: tuple


@dataclass(frozen=True)
class AmbientLight:
    color: tuple


@dataclass(frozen=True)
class DirectionalLight:
    color: tuple
    direction: tuple


@dataclass(frozen=True)
class ObjectLight:
    """Light::Object — invisible emissive geometry (light.rs:17-18)."""

    shape: object
    material: Material


class Light:
    """Constructor namespace mirroring the reference enum variants."""

    Point = staticmethod(lambda color, position: PointLight(_t(color), _t(position)))
    Ambient = staticmethod(lambda color: AmbientLight(_t(color)))
    Directional = staticmethod(lambda color, direction: DirectionalLight(_t(color), _t(direction)))

    @staticmethod
    def Object(obj) -> ObjectLight:
        return ObjectLight(obj.shape, obj._material)


def _t(v):
    if isinstance(v, Vec3):
        return (float(v.x), float(v.y), float(v.z))
    return tuple(float(x) for x in v)


# ---------------------------------------------------------------------------
# Compiled lights: (static descriptor, device tables) pairs.

AREA_SPHERE, AREA_CUBE, AREA_MESH, AREA_MONOMIAL = 0, 1, 2, 3

#: surface area of the exp=4, height=1 monomial surface
#: (monomial_surface.rs:118)
MONOMIAL_AREA = 6.3406654362


@dataclass(frozen=True)
class CompiledLight:
    kind: str  # 'point' | 'ambient' | 'directional' | 'object'
    area_kind: int = -1  # for 'object'
    n_tris: int = 0  # for AREA_MESH
    emittance: float = 0.0
    color: tuple = (0.0, 0.0, 0.0)  # material color for object lights


def _det(lin, device):
    return torch.tensor(np.linalg.det(lin), dtype=DTYPE, device=device)


def compile_light(light, device=None) -> tuple[CompiledLight, dict]:
    """Host description -> (static descriptor, tables of tensors on ``device``)."""
    if isinstance(light, PointLight):
        return CompiledLight("point"), {
            "color": Vec3.of(*light.color, device=device),
            "position": Vec3.of(*light.position, device=device),
        }
    if isinstance(light, AmbientLight):
        return CompiledLight("ambient"), {"color": Vec3.of(*light.color, device=device)}
    if isinstance(light, DirectionalLight):
        return CompiledLight("directional"), {
            "color": Vec3.of(*light.color, device=device),
            "direction": Vec3.of(*light.direction, device=device),
        }
    assert isinstance(light, ObjectLight)
    base, matrix = unwrap(light.shape)
    mat = light.material
    emit_color = Vec3.of(*mat.color_value(), device=device) * mat.emittance_value()
    common = {"emit_color": emit_color}
    static = dict(color=mat.color_value(), emittance=mat.emittance_value())
    if isinstance(base, (Sphere, Cube, MonomialSurface)):
        m4 = np.asarray(matrix, np.float64)
        lin = m4[:3, :3]
        tabs = dict(
            common,
            fwd=Affine.from_numpy(m4, device),
            inv=Affine.from_numpy(np.linalg.inv(m4), device),
            nmat=Mat3.from_numpy(np.linalg.inv(lin).T, device),
            det=_det(lin, device),
        )
        if isinstance(base, MonomialSurface):
            tabs["height"] = torch.tensor(base.height, dtype=DTYPE, device=device)
            kind = AREA_MONOMIAL
        else:
            kind = AREA_SPHERE if isinstance(base, Sphere) else AREA_CUBE
        return CompiledLight("object", kind, **static), tabs
    if isinstance(base, Mesh):
        mesh = transform_mesh(base, matrix) if isinstance(light.shape, Transformed) else base
        v = mesh.vertices
        n = mesh.normals
        areas = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
        tabs = dict(
            common,
            v1=Vec3.from_array(v[:, 0], device),
            v2=Vec3.from_array(v[:, 1], device),
            v3=Vec3.from_array(v[:, 2], device),
            n1=Vec3.from_array(n[:, 0], device),
            n2=Vec3.from_array(n[:, 1], device),
            n3=Vec3.from_array(n[:, 2], device),
            area=torch.tensor(areas, dtype=DTYPE, device=device),
        )
        return CompiledLight("object", AREA_MESH, n_tris=len(mesh), **static), tabs
    raise NotImplementedError(f"Object light over {type(base).__name__} is not supported")


# ---------------------------------------------------------------------------
# Shape sampling (vectorized over N target points)


def _sample_sphere_local(target_local: Vec3, keys):
    """Cosine-weighted hemisphere of the unit sphere facing the target
    (sphere.rs:53-65). Returns (point, normal, pdf) in local space."""
    r1, r2 = sampling.uniform2(sampling.fold(keys, 0x5A1))
    x, y = sampling.unit_disc(r1, r2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    n = target_local.normalize()
    use_x = torch.abs(n.x) > 1e-12
    zero = torch.zeros_like(n.x)
    n1 = where(use_x, Vec3(n.y, -n.x, zero), Vec3(zero, -n.z, n.y)).normalize()
    n2 = n1.cross(n)
    p = n1 * x + n2 * y + n * z
    return p, p, z * sampling.INV_PI


def _sample_cube_local(keys):
    """Uniform face sampling, pdf 1/6 (cube.rs:76-89)."""
    a, b, f = sampling.draw(keys, *(sampling.Draw((tag,)) for tag in (0xC1, 0xC2, 0xC3)))
    a, b = a - 0.5, b - 0.5
    face = (f * 6.0).to(torch.int32)
    face = torch.clamp(face, 0, 5)
    half = torch.full_like(a, 0.5)
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)
    vs = [
        (Vec3(a, b, half), Vec3(zero, zero, one)),
        (Vec3(a, b, -half), Vec3(zero, zero, -one)),
        (Vec3(a, half, b), Vec3(zero, one, zero)),
        (Vec3(a, -half, b), Vec3(zero, -one, zero)),
        (Vec3(half, a, b), Vec3(one, zero, zero)),
        (Vec3(-half, a, b), Vec3(-one, zero, zero)),
    ]
    v, n = vs[0]
    for k in range(1, 6):
        sel = face == k
        v = where(sel, vs[k][0], v)
        n = where(sel, vs[k][1], n)
    return v, n, torch.full_like(a, 1.0 / 6.0)


def _transformed_sample(tabs, local_v, local_n, local_pdf):
    """Transformed::sample pdf correction (shape.rs:140-151)."""
    fwd: Affine = tabs["fwd"]
    nmat: Mat3 = tabs["nmat"]
    world_n = nmat.apply(local_n).normalize()
    height = fwd.linear.apply(local_n).dot(world_n)
    base = tabs["det"] / height
    return fwd.apply_point(local_v), world_n, local_pdf / base


def _sample_monomial_local(height, keys):
    """Uniform unit-circle sample lifted to the surface, two-sided normal
    flip, pdf 1/(2*AREA) (monomial_surface.rs:109-124)."""
    r1, u_flip = sampling.draw(keys, sampling.Draw((0x31,)), sampling.Draw((0x32,)))
    x, z = sampling.unit_circle(r1)
    r2 = x * x + z * z
    pos = Vec3(x, height * r2 * r2, z)
    normal = Vec3(height * 4.0 * x * r2, -torch.ones_like(x), height * 4.0 * z * r2).normalize()
    flip = u_flip < 0.5
    normal = where(flip, -normal, normal)
    pdf = torch.full_like(x, 1.0 / (2.0 * MONOMIAL_AREA))
    return pos, normal, pdf


def sample_shape(static: CompiledLight, tabs, target: Vec3, keys):
    """shape.sample(target) -> (point, normal, pdf), vectorized."""
    if static.area_kind == AREA_SPHERE:
        inv: Affine = tabs["inv"]
        lv, ln, lp = _sample_sphere_local(inv.apply_point(target), keys)
        return _transformed_sample(tabs, lv, ln, lp)
    if static.area_kind == AREA_CUBE:
        return _transformed_sample(tabs, *_sample_cube_local(keys))
    if static.area_kind == AREA_MONOMIAL:
        return _transformed_sample(tabs, *_sample_monomial_local(tabs["height"], keys))
    assert static.area_kind == AREA_MESH
    # KdTree::sample: uniform object, pdf / n (kdtree.rs:141-147)
    n = static.n_tris
    u_idx, u, v = sampling.draw(keys, *(sampling.Draw((tag,)) for tag in (0x731, 0x732, 0x733)))
    idx = torch.clamp((u_idx * n).to(torch.int64), 0, n - 1)
    # fold instead of the reference's rejection loop (mesh.rs:86-91)
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    w = 1.0 - u - v
    v1, v2, v3 = take(tabs["v1"], idx), take(tabs["v2"], idx), take(tabs["v3"], idx)
    n1, n2, n3 = take(tabs["n1"], idx), take(tabs["n2"], idx), take(tabs["n3"], idx)
    point = v1 * u + v2 * v + v3 * w
    normal = (n1 * u + n2 * v + n3 * w).normalize()
    pdf = 1.0 / (tabs["area"][idx] * n)
    return point, normal, pdf


def illuminate(static: CompiledLight, tabs, world_pos: Vec3, keys):
    """Light::illuminate (light.rs:22-47): returns (intensity, wi, dist).
    Ambient lights are handled by the integrators (renderer.rs:377-378)."""
    shape = world_pos.shape
    if static.kind == "point":
        disp = tabs["position"].broadcast_to(shape) - world_pos
        dist = disp.length()
        return tabs["color"].broadcast_to(shape) / (dist * dist), disp / dist, dist
    if static.kind == "directional":
        wi = (-tabs["direction"].broadcast_to(shape)).normalize()
        full = torch.full(shape, INF, dtype=DTYPE, device=world_pos.device)
        return tabs["color"].broadcast_to(shape), wi, full
    assert static.kind == "object"
    v, n, p = sample_shape(static, tabs, world_pos, keys)
    disp = v - world_pos
    dist = disp.length()
    cosine = torch.clamp(-disp.dot(n), min=0.0) / dist
    surface_area = torch.clamp(cosine, min=0.0) / (dist * dist)
    intensity = tabs["emit_color"].broadcast_to(shape) * (surface_area / p)
    return intensity, disp / dist, dist
