"""Analytic-primitive closest hit and any hit (K-prim).

The JAX package tests every ray against the scene's spheres, cubes, planes
and monomial surfaces in one XLA program (`rpt_tpu/intersect.py:832`
``_prim_best``, its loop `_foreach_prim` `:128`, one device
``fori_loop`` above 8 prims). The port's plain version is the per-type
chain below (`intersect_spheres`, `intersect_cubes`, `intersect_planes`,
`intersect_monomials`, merged by `closer`; `rpt/src/shape/*.rs`): a chain
of torch ops per prim per call, over the scene's `PrimSet`s and
`PlaneSet`. The kernel is `csrc/prim_hit.cu`, one thread a ray over every
prim.

`pack_prims` packs those tables into one float32 row table for the
kernel, in the order `_prim_best` visits them (spheres, cubes, planes,
monomials; prims in table order), with a header of the four counts.

`prim_closest_hit` and `prim_any_hit` are the wrappers: for rays on the
CPU they run the per-type chain; for CUDA tensors they launch the kernel,
once a call (`_build.launch`), or raise.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from ..dtypes import DTYPE, EPS, INF
from ..ray import Hit, Ray, aabb_interval, closer
from ..vec import Affine, Mat3, Vec3, where


@dataclass(frozen=True)
class PrimSet:
    """A batch of one analytic primitive type, each with its own transform
    (``Transformed<T>``, shape.rs:102-126): rays are inverse-transformed
    into object space; normals map by M^-T."""

    world_to_obj: Affine  # (P,)
    normal_mat: Mat3  # (P,) inverse-transpose of the linear part
    obj_to_world: Affine  # (P,)
    det: torch.Tensor  # (P,) determinant of the linear part
    material: torch.Tensor  # (P,) int32
    param: torch.Tensor  # (P,) extra parameter (monomial height)

    @property
    def n(self) -> int:
        return int(self.material.shape[0])


@dataclass(frozen=True)
class PlaneSet:
    normal: Vec3  # (P,)
    value: torch.Tensor  # (P,)
    material: torch.Tensor  # (P,) int32

    @property
    def n(self) -> int:
        return int(self.material.shape[0])


# Row layout (`csrc/prim_hit.cu` kRow). A sphere, cube or monomial row:
#   [0:9] world_to_obj linear (row-major), [9:12] its translation,
#   [12:21] normal_mat (row-major), [21] material, [22] param (the
#   monomial's height), [23] 0.
# A plane row: [0:3] normal, [3] value, [21] material, the rest 0.
ROW = 24
MATERIAL, PARAM = 21, 22
KINDS = ("spheres", "cubes", "planes", "monomials")
MAX_MATERIAL = 1 << 24  # materials are stored as exact float32 integers


@dataclass(frozen=True)
class PrimRows:
    """A scene's analytic prims packed for K-prim: ``rows`` (R, `ROW`)
    float32, ``counts`` the header (spheres, cubes, planes, monomials),
    whose sum is R, and ``sets``, the per-type `PrimSet`/`PlaneSet` tables
    by kind, which the plain version runs."""

    rows: torch.Tensor
    counts: tuple
    sets: dict

    @property
    def n(self) -> int:
        return sum(self.counts)


def _prim_rows(prims) -> torch.Tensor:
    lin, tr, nm = prims.world_to_obj.linear, prims.world_to_obj.translation, prims.normal_mat
    cols = [getattr(lin, f"m{i}{j}") for i in range(3) for j in range(3)]
    cols += [tr.x, tr.y, tr.z]
    cols += [getattr(nm, f"m{i}{j}") for i in range(3) for j in range(3)]
    cols += [prims.material.to(DTYPE), prims.param, torch.zeros_like(prims.param)]
    return torch.stack(cols, dim=1)


def _plane_rows(planes) -> torch.Tensor:
    zero = torch.zeros_like(planes.value)
    cols = [planes.normal.x, planes.normal.y, planes.normal.z, planes.value]
    cols += [zero] * (MATERIAL - 4) + [planes.material.to(DTYPE), zero, zero]
    return torch.stack(cols, dim=1)


def pack_prims(tables: dict, device=None) -> PrimRows:
    """The rows of the prims in ``tables`` (a compiled scene's ``"spheres"``,
    ``"cubes"``, ``"planes"``, ``"monomials"``, where present), on their
    device or ``device`` where there are none."""
    sets = {kind: tables[kind] for kind in KINDS if kind in tables}
    parts = [(_plane_rows if kind == "planes" else _prim_rows)(s) for kind, s in sets.items()]
    if parts:
        rows = torch.cat(parts).contiguous()
    else:
        rows = torch.zeros((0, ROW), dtype=DTYPE, device=device)
    counts = tuple(sets[kind].n if kind in sets else 0 for kind in KINDS)
    if max((int(s.material.max()) for s in sets.values() if s.n), default=0) >= MAX_MATERIAL:
        raise ValueError(f"pack_prims: material ids must be < {MAX_MATERIAL}")
    return PrimRows(rows, counts, sets)


def _check_rows(name: str, prims: PrimRows) -> None:
    rows, counts = prims.rows, prims.counts
    if rows.dim() != 2 or rows.shape[1] != ROW or rows.dtype != DTYPE or not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous float32 (R, {ROW}), got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if (len(counts) != len(KINDS) or any(not isinstance(c, int) or c < 0 for c in counts)
            or sum(counts) != rows.shape[0]):
        raise ValueError(f"{name}: the header {counts} does not count the {rows.shape[0]} rows "
                         f"as (spheres, cubes, planes, monomials)")
    if rows.shape[0] >= 1 << 30:
        raise ValueError(f"{name}: {rows.shape[0]} rows; the kernel indexes them with int32")
    if rows.device.type == "cuda" and rows.data_ptr() % 16:
        raise ValueError(f"{name}: the rows must be 16-byte aligned (the kernel reads float4)")


# ---------------------------------------------------------------------------
# The plain version: the per-type chain. Each intersector returns a Hit
# (time=inf on a miss) merged into ``best`` with `closer`.


def _local_hit_to_world(prims: PrimSet, i, local_n: Vec3, t, ok) -> Hit:
    world_n = prims.normal_mat[i].apply(local_n).normalize()
    time = torch.where(ok, t, INF)
    mat = prims.material[i].to(torch.int32).expand(t.shape)
    return Hit(time, world_n, mat)


def _foreach_prim(n: int, body_hit, best: Hit) -> Hit:
    for i in range(n):
        best = closer(best, body_hit(i))
    return best


def intersect_spheres(prims: PrimSet, ray: Ray, t_min, best: Hit) -> Hit:
    """Unit sphere quadratic (shape/sphere.rs:14-46), per transformed prim."""

    def body(i):
        local = ray.transform(prims.world_to_obj[i])
        a = local.dir.length_squared()
        b = local.dir.dot(local.origin)
        c = local.origin.length_squared() - 1.0
        disc = b * b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_minus = (-b - sq) / a
        t_plus = (-b + sq) / a
        t = torch.where(t_minus < t_min, t_plus, t_minus)
        ok = (disc >= 0.0) & (t >= t_min)
        return _local_hit_to_world(prims, i, local.at(t).normalize(), t, ok)

    return _foreach_prim(prims.n, body, best)


def intersect_cubes(prims: PrimSet, ray: Ray, t_min, best: Hit) -> Hit:
    """Unit-cube slab test with per-axis entry/exit normals
    (shape/cube.rs:22-74)."""

    def body(i):
        local = ray.transform(prims.world_to_obj[i])

        def interval(o, d):
            x1 = (-0.5 - o) / d
            x2 = (0.5 - o) / d
            one = torch.ones_like(x1)
            return torch.minimum(x1, x2), torch.maximum(x1, x2), torch.where(x1 > x2, one, -one)

        x1, x2, sx = interval(local.origin.x, local.dir.x)
        y1, y2, sy = interval(local.origin.y, local.dir.y)
        z1, z2, sz = interval(local.origin.z, local.dir.z)
        # entry: the largest near-plane, with the reference's tie-breaking
        # (cube.rs:40-48)
        x_first = (x1 > y1) & (x1 > z1)
        y_first = (~x_first) & (y1 > z1)
        z_first = ~(x_first | y_first)
        start = torch.where(x_first, x1, torch.where(y_first, y1, z1))
        zero = torch.zeros_like(x1)
        start_n = Vec3(torch.where(x_first, sx, zero), torch.where(y_first, sy, zero),
                       torch.where(z_first, sz, zero))
        x_last = (x2 < y2) & (x2 < z2)
        y_last = (~x_last) & (y2 < z2)
        z_last = ~(x_last | y_last)
        end = torch.where(x_last, x2, torch.where(y_last, y2, z2))
        end_n = Vec3(torch.where(x_last, -sx, zero), torch.where(y_last, -sy, zero),
                     torch.where(z_last, -sz, zero))
        ok = (start <= end) & (end >= t_min)
        inside = start < t_min
        t = torch.where(inside, end, start)
        return _local_hit_to_world(prims, i, where(inside, end_n, start_n), t, ok)

    return _foreach_prim(prims.n, body, best)


def intersect_planes(planes: PlaneSet, ray: Ray, t_min, best: Hit) -> Hit:
    """x . normal = value (shape/plane.rs:17-32); normal flipped against
    the ray. Keeps the JAX package's f32 on-plane guard: an origin within
    f32 rounding of the plane is never occluded by it (see
    `rpt_tpu/intersect.py:205-224`)."""

    def body(i):
        n = planes.normal[i].broadcast_to(ray.origin.shape)
        cosine = n.dot(ray.dir)
        num = planes.value[i] - n.dot(ray.origin)
        t = num / cosine
        n_l1 = torch.abs(n.x) + torch.abs(n.y) + torch.abs(n.z)
        scale = n_l1 * (
            torch.abs(ray.origin.x) + torch.abs(ray.origin.y) + torch.abs(ray.origin.z)
        ) + torch.abs(planes.value[i])
        on_plane = torch.abs(num) <= (32.0 * EPS) * scale
        ok = (torch.abs(cosine) >= 1e-8) & (t >= t_min) & ~on_plane
        normal = -n.normalize() * torch.sign(cosine)
        mat = planes.material[i].to(torch.int32).expand(t.shape)
        return Hit(torch.where(ok, t, INF), normal, mat)

    return _foreach_prim(planes.n, body, best)


def intersect_monomials(prims: PrimSet, ray: Ray, t_min, best: Hit) -> Hit:
    """Newton + 60-step bisection for y = h (x^2+z^2)^2
    (shape/monomial_surface.rs:22-107), fixed iteration counts, masked."""

    def body(i):
        local = ray.transform(prims.world_to_obj[i])
        h = prims.param[i]
        o, d = local.origin, local.dir

        def dist(t):
            x = o.x + t * d.x
            y = o.y + t * d.y
            z = o.z + t * d.z
            return y - h * (x * x + z * z) ** 2

        coef0 = o.x * o.x + o.z * o.z
        coef1 = 2.0 * (o.x * d.x + o.z * d.z)
        coef2 = d.x * d.x + d.z * d.z

        def deriv(t):
            dy = (
                2.0 * coef0 * coef1
                + 2.0 * t * (coef1 * coef1 + 2.0 * coef0 * coef2)
                + 3.0 * t * t * 2.0 * coef1 * coef2
                + 4.0 * t * t * t * coef2 * coef2
            )
            return d.y - h * dy

        def deriv2(t):
            dy = (
                2.0 * (coef1 * coef1 + 2.0 * coef0 * coef2)
                + 6.0 * t * 2.0 * coef1 * coef2
                + 12.0 * t * t * coef2 * coef2
            )
            return -h * dy

        one = torch.ones_like(h)
        b_min, b_max = aabb_interval(
            local, Vec3.of(-1.0, 0.0, -1.0, device=h.device), Vec3(one, h, one)
        )
        feasible = torch.clamp(b_min, min=t_min) <= torch.minimum(b_max, best.time)

        t_min_v = torch.full_like(b_min, t_min)
        maximize = dist(t_min_v) < 0.0
        cur = (b_min + b_max) / 2.0
        stop = torch.zeros_like(maximize)
        for _ in range(10):
            stop = stop | (dist(cur) > 0.0)
            step = deriv(cur) / deriv2(cur)
            cur = torch.where(stop | ~maximize, cur, cur - step)
        t_max = torch.where(maximize, cur, torch.full_like(cur, 10000.0))
        feasible = feasible & ~(maximize & (t_max < t_min))
        feasible = feasible & ((dist(t_min_v) < 0.0) != (dist(t_max) < 0.0))

        lo = t_min_v
        r = t_max
        for _ in range(60):
            m = (lo + r) / 2.0
            go_right = (dist(m) >= 0.0) == maximize
            r = torch.where(go_right, m, r)
            lo = torch.where(go_right, lo, m)

        pos = local.at(r)
        rad2 = pos.x * pos.x + pos.z * pos.z
        ok = feasible & (rad2 <= 1.0)
        local_n = Vec3(h * 4.0 * pos.x * rad2, -torch.ones_like(rad2),
                       h * 4.0 * pos.z * rad2).normalize()
        flip = local_n.dot(local.dir) > 0.0
        local_n = where(flip, -local_n, local_n)
        return _local_hit_to_world(prims, i, local_n, r, ok)

    return _foreach_prim(prims.n, body, best)


def prim_closest_hit_plain(prims: PrimRows, ray: Ray, t_min) -> Hit:
    """Masked-min closest hit over the per-type batches, in `_prim_best`'s
    order (`rpt_tpu/intersect.py:832`)."""
    best = Hit.none(ray.origin.x.shape, ray.origin.x.device)
    for kind, fn in (("spheres", intersect_spheres), ("cubes", intersect_cubes),
                     ("planes", intersect_planes), ("monomials", intersect_monomials)):
        if kind in prims.sets and prims.sets[kind].n:
            best = fn(prims.sets[kind], ray, t_min, best)
    return best


def prim_any_hit_plain(prims: PrimRows, ray: Ray, t_min, limit) -> torch.Tensor:
    """True where some prim lies at t in [t_min, limit)."""
    return prim_closest_hit_plain(prims, ray, t_min).time < limit


# ---------------------------------------------------------------------------
# The kernel


class _PrimParams(ctypes.Structure):
    """`csrc/prim_hit.cu` PrimParams, passed by value to the kernel."""

    _fields_ = [("ray", ctypes.c_void_p * 6), ("stride", ctypes.c_int64 * 6),
                ("rows", ctypes.c_void_p), ("limit", ctypes.c_void_p),
                ("limit_stride", ctypes.c_int64), ("out_t", ctypes.c_void_p),
                ("out_normal", ctypes.c_void_p), ("out_material", ctypes.c_void_p),
                ("out_hit", ctypes.c_void_p), ("n", ctypes.c_int), ("counts", ctypes.c_int * 4),
                ("t_min", ctypes.c_float)]


def _params(prims: PrimRows, comps, t_min) -> _PrimParams:
    p = _PrimParams()
    for k, c in enumerate(comps):
        p.ray[k], p.stride[k] = c.data_ptr(), c.stride(0)
    p.rows, p.n, p.t_min = prims.rows.data_ptr(), comps[0].shape[0], float(t_min)
    p.counts[:] = prims.counts
    return p


def prim_closest_hit(prims: PrimRows, ray: Ray, t_min) -> Hit:
    """The nearest prim hit per ray in [t_min, inf): time (inf on a miss),
    world normal (zero on a miss) and material (-1 on a miss), as
    `_prim_best`. CPU rays take `prim_closest_hit_plain`; CUDA rays launch
    K-prim once."""
    _check_rows("prim_closest_hit", prims)
    comps, shape = _build.lanes("prim_closest_hit", prims.rows, ray)
    if comps[0].device.type == "cpu":
        return prim_closest_hit_plain(prims, ray, t_min)
    n, dev = comps[0].shape[0], comps[0].device
    out_t = torch.empty(n, dtype=DTYPE, device=dev)
    out_n = torch.empty((3, n), dtype=DTYPE, device=dev)
    out_m = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        p = _params(prims, comps, t_min)
        p.out_t, p.out_normal, p.out_material = (out_t.data_ptr(), out_n.data_ptr(),
                                                 out_m.data_ptr())
        _build.launch("prim_closest_hit", "rpt_prim_closest_hit", out_t, ctypes.byref(p))
    return Hit(out_t.reshape(shape), Vec3(*(c.reshape(shape) for c in out_n)),
               out_m.reshape(shape))


def prim_any_hit(prims: PrimRows, ray: Ray, t_min, limit) -> torch.Tensor:
    """True where some prim lies at t in [t_min, limit) (``limit`` a number
    or a tensor that broadcasts against the lanes): ``_prim_best(...).time <
    limit``. Lanes with ``limit <= t_min`` are False. CPU rays take
    `prim_any_hit_plain`; CUDA rays launch K-prim once, which stops a lane
    at its first prim before ``limit``."""
    _check_rows("prim_any_hit", prims)
    comps, shape = _build.lanes("prim_any_hit", prims.rows, ray)
    if comps[0].device.type == "cpu":
        return prim_any_hit_plain(prims, ray, t_min, limit)
    n, dev = comps[0].shape[0], comps[0].device
    limit = _build.lane_tensor("prim_any_hit", "limit", limit, DTYPE, shape, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        p = _params(prims, comps, t_min)
        p.limit, p.limit_stride, p.out_hit = limit.data_ptr(), limit.stride(0), out.data_ptr()
        _build.launch("prim_any_hit", "rpt_prim_any_hit", out, ctypes.byref(p))
    return out.reshape(shape)
