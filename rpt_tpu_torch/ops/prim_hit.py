"""Analytic-primitive closest hit and any hit (K-prim).

The JAX package tests every ray against the scene's spheres, cubes, planes
and monomial surfaces in one XLA program (`rpt_tpu/intersect.py:832`
``_prim_best``, its loop `_foreach_prim` `:128`, one device
``fori_loop`` above 8 prims). The port's plain version is the per-type
chain of `rpt_tpu_torch.intersect` (`intersect_spheres`, `intersect_cubes`,
`intersect_planes`, `intersect_monomials`, merged by `closer`): a chain of
torch ops per prim per call. The kernel is `csrc/prim_hit.cu`, one thread a
ray over every prim.

`pack_prims` packs a compiled scene's `PrimSet`s and `PlaneSet` into one
float32 row table, in the order `_prim_best` visits them (spheres, cubes,
planes, monomials; prims in table order), with a header of the four
counts. `prim_hit_flat_plain` is the kernel's per-lane arithmetic over
those rows in torch ops (each prim's time, the running best with the
first prim winning a tie, the monomials' feasibility bound from the best
entering their batch, then the winner's normal): the CPU twin of the
kernel, held bit for bit to the per-type chain by the tests.

`prim_closest_hit` and `prim_any_hit` are the wrappers: for rays on the
CPU they run the per-type chain; for CUDA tensors they launch the kernel,
once a call, or raise. ``prim_closest_hit.launches`` and
``prim_any_hit.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from itertools import accumulate

import torch

from . import _build
from ..dtypes import DTYPE, EPS, INF
from ..ray import Hit, Ray
from ..vec import Affine, Mat3, Vec3, where

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


def _lanes(name: str, rows: torch.Tensor, ray: Ray):
    """The ray's six components broadcast to one lane shape and flattened
    (views where they can be), and that shape; they must be float32 on the
    device of the table ``rows``."""
    comps = torch.broadcast_tensors(ray.origin.x, ray.origin.y, ray.origin.z,
                                    ray.dir.x, ray.dir.y, ray.dir.z)
    for c in comps:
        if c.dtype != DTYPE:
            raise ValueError(f"{name}: ray components must be float32, got {c.dtype}")
        if c.device != rows.device:
            raise ValueError(f"{name}: the ray is on {c.device}, the rows on {rows.device}")
    return [c.reshape(-1) for c in comps], comps[0].shape


def _lane_tensor(name: str, what: str, x, dtype, shape, dev) -> torch.Tensor:
    """``x`` (a number or a tensor that broadcasts against the lanes) as a
    flat view over the lanes, of ``dtype`` on ``dev``."""
    if isinstance(x, torch.Tensor) and (x.dtype != dtype or x.device != dev):
        raise ValueError(f"{name}: {what} must be {dtype} on {dev}, got {x.dtype} on {x.device}")
    return torch.as_tensor(x, dtype=dtype, device=dev).expand(shape).reshape(-1)


def _on_card(name: str, comps, rows: torch.Tensor | None = None) -> None:
    """Refuse lanes off the card or past int32; ``rows``, where given, must
    be 16-byte aligned (the kernel reads them as float4)."""
    if comps[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {comps[0].device}")
    if rows is not None and rows.data_ptr() % 16:
        raise ValueError(f"{name}: the rows must be 16-byte aligned")
    if comps[0].shape[0] >= 1 << 31:
        raise ValueError(f"{name}: {comps[0].shape[0]} lanes; the kernel counts them in int32")


# ---------------------------------------------------------------------------
# The plain version: the per-type chain of `rpt_tpu_torch.intersect`


def prim_closest_hit_plain(prims: PrimRows, ray: Ray, t_min) -> Hit:
    """Masked-min closest hit over the per-type batches, in `_prim_best`'s
    order (`rpt_tpu/intersect.py:832`)."""
    from .. import intersect

    best = Hit.none(ray.origin.x.shape, ray.origin.x.device)
    for kind, fn in (("spheres", intersect.intersect_spheres),
                     ("cubes", intersect.intersect_cubes),
                     ("planes", intersect.intersect_planes),
                     ("monomials", intersect.intersect_monomials)):
        if kind in prims.sets and prims.sets[kind].n:
            best = fn(prims.sets[kind], ray, t_min, best)
    return best


def prim_any_hit_plain(prims: PrimRows, ray: Ray, t_min, limit) -> torch.Tensor:
    """True where some prim lies at t in [t_min, limit)."""
    return prim_closest_hit_plain(prims, ray, t_min).time < limit


# ---------------------------------------------------------------------------
# The kernel's per-lane arithmetic over the packed rows, in torch ops.
# Each function takes a row as a list of ROW tensors: 0-dim (one row for
# every lane) or (n,) (each lane's own row, for the winner's normal).


def _to_local(row, ray: Ray) -> Ray:
    return ray.transform(Affine(Mat3(*row[0:9]), Vec3(*row[9:12])))


def _to_world(row, local_n: Vec3) -> Vec3:
    return Mat3(*row[12:21]).apply(local_n).normalize()


def _sphere_time(row, ray: Ray, t_min):
    lo = _to_local(row, ray)
    a = lo.dir.dot(lo.dir)
    b = lo.dir.dot(lo.origin)
    c = lo.origin.dot(lo.origin) - 1.0
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_minus = (-b - sq) / a
    t_plus = (-b + sq) / a
    t = torch.where(t_minus < t_min, t_plus, t_minus)
    return torch.where((disc >= 0.0) & (t >= t_min), t, INF)


def _sphere_normal(row, ray: Ray, t):
    return _to_world(row, _to_local(row, ray).at(t).normalize())


def _cube_faces(row, ray: Ray):
    lo = _to_local(row, ray)

    def axis(o, d):
        x1 = (-0.5 - o) / d
        x2 = (0.5 - o) / d
        one = torch.ones_like(x1)
        return torch.minimum(x1, x2), torch.maximum(x1, x2), torch.where(x1 > x2, one, -one)

    (x1, x2, sx), (y1, y2, sy), (z1, z2, sz) = (axis(lo.origin.x, lo.dir.x),
                                                axis(lo.origin.y, lo.dir.y),
                                                axis(lo.origin.z, lo.dir.z))
    x_first = (x1 > y1) & (x1 > z1)
    y_first = ~x_first & (y1 > z1)
    z_first = ~(x_first | y_first)
    start = torch.where(x_first, x1, torch.where(y_first, y1, z1))
    x_last = (x2 < y2) & (x2 < z2)
    y_last = ~x_last & (y2 < z2)
    z_last = ~(x_last | y_last)
    end = torch.where(x_last, x2, torch.where(y_last, y2, z2))
    zero = torch.zeros_like(x1)
    start_n = Vec3(torch.where(x_first, sx, zero), torch.where(y_first, sy, zero),
                   torch.where(z_first, sz, zero))
    end_n = Vec3(torch.where(x_last, -sx, zero), torch.where(y_last, -sy, zero),
                 torch.where(z_last, -sz, zero))
    return start, end, start_n, end_n


def _cube_time(row, ray: Ray, t_min):
    start, end, _, _ = _cube_faces(row, ray)
    ok = (start <= end) & (end >= t_min)
    return torch.where(ok, torch.where(start < t_min, end, start), INF)


def _cube_normal(row, ray: Ray, t_min):
    start, _, start_n, end_n = _cube_faces(row, ray)
    return _to_world(row, where(start < t_min, end_n, start_n))


def _plane_time(row, ray: Ray, t_min):
    n = Vec3(*row[0:3])
    value = row[3]
    cosine = n.dot(ray.dir)
    num = value - n.dot(ray.origin)
    t = num / cosine
    n_l1 = torch.abs(n.x) + torch.abs(n.y) + torch.abs(n.z)
    scale = n_l1 * ray.origin.abs().sum() + torch.abs(value)
    on_plane = torch.abs(num) <= (32.0 * EPS) * scale
    ok = (torch.abs(cosine) >= 1e-8) & (t >= t_min) & ~on_plane
    return torch.where(ok, t, INF)


def _plane_normal(row, ray: Ray):
    n = Vec3(*row[0:3])
    return -n.normalize() * torch.sign(n.dot(ray.dir))


class _Monomial:
    """y = h (x^2 + z^2)^2 in a row's object space: the distance function
    and its two derivatives in t (`intersect_monomials`' algebra)."""

    def __init__(self, row, ray: Ray):
        self.local = _to_local(row, ray)
        self.h = row[PARAM]
        o, d = self.local.origin, self.local.dir
        self.coef0 = o.x * o.x + o.z * o.z
        self.coef1 = 2.0 * (o.x * d.x + o.z * d.z)
        self.coef2 = d.x * d.x + d.z * d.z

    def dist(self, t):
        o, d = self.local.origin, self.local.dir
        x, y, z = o.x + t * d.x, o.y + t * d.y, o.z + t * d.z
        return y - self.h * (x * x + z * z) ** 2

    def deriv(self, t):
        c0, c1, c2 = self.coef0, self.coef1, self.coef2
        dy = (2.0 * c0 * c1 + 2.0 * t * (c1 * c1 + 2.0 * c0 * c2) + 3.0 * t * t * 2.0 * c1 * c2
              + 4.0 * t * t * t * c2 * c2)
        return self.local.dir.y - self.h * dy

    def deriv2(self, t):
        c0, c1, c2 = self.coef0, self.coef1, self.coef2
        dy = 2.0 * (c1 * c1 + 2.0 * c0 * c2) + 6.0 * t * 2.0 * c1 * c2 + 12.0 * t * t * c2 * c2
        return -self.h * dy


def _monomial_box(m: _Monomial, t_min, entry):
    """The monomial's box interval ([-1, 0, -1] .. [1, h, 1] in object
    space, `_slab_interval`) and whether a hit in it can lie before
    ``entry``."""
    lo = m.local
    inv = lo.dir.map(torch.reciprocal)
    one = torch.ones_like(m.h)
    t1 = (Vec3(-one, torch.zeros_like(m.h), -one) - lo.origin) * inv
    t2 = (Vec3(one, m.h, one) - lo.origin) * inv
    b_min = t1.minimum(t2).map(lambda c: torch.where(torch.isnan(c), -INF, c)).max_component()
    b_max = t1.maximum(t2).map(lambda c: torch.where(torch.isnan(c), INF, c)).min_component()
    return b_min, b_max, torch.clamp(b_min, min=t_min) <= torch.minimum(b_max, entry)


def _monomial_time(row, ray: Ray, t_min, entry):
    """The monomial's hit time; ``entry`` is the best time entering the
    monomial batch (after spheres, cubes and planes), which bounds it."""
    m = _Monomial(row, ray)
    b_min, b_max, feasible = _monomial_box(m, t_min, entry)
    t_min_v = torch.full_like(b_min, t_min)
    maximize = m.dist(t_min_v) < 0.0
    cur = (b_min + b_max) / 2.0
    stop = torch.zeros_like(maximize)
    for _ in range(10):
        stop = stop | (m.dist(cur) > 0.0)
        cur = torch.where(stop | ~maximize, cur, cur - m.deriv(cur) / m.deriv2(cur))
    t_max = torch.where(maximize, cur, torch.full_like(cur, 10000.0))
    feasible = feasible & ~(maximize & (t_max < t_min))
    feasible = feasible & (maximize != (m.dist(t_max) < 0.0))
    left, right = t_min_v, t_max
    for _ in range(60):
        mid = (left + right) / 2.0
        go_right = (m.dist(mid) >= 0.0) == maximize
        right = torch.where(go_right, mid, right)
        left = torch.where(go_right, left, mid)
    pos = m.local.at(right)
    ok = feasible & (pos.x * pos.x + pos.z * pos.z <= 1.0)
    return torch.where(ok, right, INF)


def monomial_searches(prims: PrimRows, ray: Ray, t_min, lanes=None) -> int:
    """How many (lane, monomial) pairs pass the box test, against the best
    entering the monomial batch, and so run the Newton and bisection search
    in the kernel (of the lanes in the bool mask ``lanes``, where given):
    the data-dependent part of K-prim's work, for its bound."""
    if not prims.counts[3]:
        return 0
    begin = sum(prims.counts[:3])
    front = PrimRows(prims.rows[:begin], (*prims.counts[:3], 0),
                     {k: v for k, v in prims.sets.items() if k != "monomials"})
    entry = prim_closest_hit_plain(front, ray, t_min).time
    total = 0
    for j in range(begin, prims.n):
        feasible = _monomial_box(_Monomial(list(prims.rows[j].unbind()), ray), t_min, entry)[2]
        total += int((feasible if lanes is None else feasible & lanes).sum())
    return total


def _monomial_normal(row, ray: Ray, t):
    lo = _to_local(row, ray)
    pos = lo.at(t)
    rad2 = pos.x * pos.x + pos.z * pos.z
    h4 = row[PARAM] * 4.0
    n = Vec3(h4 * pos.x * rad2, -torch.ones_like(rad2), h4 * pos.z * rad2).normalize()
    return _to_world(row, where(n.dot(lo.dir) > 0.0, -n, n))


def prim_hit_flat_plain(prims: PrimRows, ray: Ray, t_min, limit=None):
    """The kernel's arithmetic over the packed rows, lane for lane: each
    row's hit time in turn, the running best taking a row only where it is
    strictly closer (the first prim wins a tie), the monomials bounded by
    the best entering their batch; then the winner's world normal and
    material. A `Hit`, or with ``limit`` the booleans ``best < limit``."""
    _check_rows("prim_hit_flat_plain", prims)
    comps, shape = _lanes("prim_hit_flat_plain", prims.rows, ray)
    ray = Ray(Vec3(*comps[:3]), Vec3(*comps[3:]))
    n, dev = comps[0].shape[0], prims.rows.device
    ends = list(accumulate(prims.counts))
    best_t = torch.full((n,), INF, dtype=DTYPE, device=dev)
    best_j = torch.full((n,), -1, dtype=torch.int64, device=dev)
    entry = best_t
    for j in range(prims.n):
        row = list(prims.rows[j].unbind())
        if j < ends[0]:
            t = _sphere_time(row, ray, t_min)
        elif j < ends[1]:
            t = _cube_time(row, ray, t_min)
        elif j < ends[2]:
            t = _plane_time(row, ray, t_min)
        else:
            if j == ends[2]:
                entry = best_t
            t = _monomial_time(row, ray, t_min, entry)
        take = t < best_t
        best_t = torch.where(take, t, best_t)
        best_j = torch.where(take, j, best_j)
    if limit is not None:
        return (best_t < torch.as_tensor(limit, dtype=DTYPE, device=dev).reshape(-1)).reshape(shape)
    if not prims.n:
        return Hit.none(shape, dev)

    won = best_j >= 0
    lane_rows = list(prims.rows[best_j.clamp(min=0)].unbind(1))
    normal = Vec3.zeros((n,), dev)
    for kind, begin, end in zip(KINDS, [0, *ends[:3]], ends):
        mine = won & (best_j >= begin) & (best_j < end)
        if not bool(mine.any()):
            continue
        if kind == "spheres":
            kn = _sphere_normal(lane_rows, ray, best_t)
        elif kind == "cubes":
            kn = _cube_normal(lane_rows, ray, t_min)
        elif kind == "planes":
            kn = _plane_normal(lane_rows, ray)
        else:
            kn = _monomial_normal(lane_rows, ray, best_t)
        normal = where(mine, kn, normal)
    material = torch.where(won, lane_rows[MATERIAL].to(torch.int32), -1)
    return Hit(best_t.reshape(shape), normal.reshape(shape), material.reshape(shape))


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
    comps, shape = _lanes("prim_closest_hit", prims.rows, ray)
    if comps[0].device.type == "cpu":
        return prim_closest_hit_plain(prims, ray, t_min)
    _on_card("prim_closest_hit", comps, prims.rows)
    n, dev = comps[0].shape[0], comps[0].device
    out_t = torch.empty(n, dtype=DTYPE, device=dev)
    out_n = torch.empty((3, n), dtype=DTYPE, device=dev)
    out_m = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        p = _params(prims, comps, t_min)
        p.out_t, p.out_normal, p.out_material = (out_t.data_ptr(), out_n.data_ptr(),
                                                 out_m.data_ptr())
        code = _build.library().lib.rpt_prim_closest_hit(ctypes.byref(p),
                                                          _build.stream_of(out_t))
        prim_closest_hit.launches += 1
        _build.check(code, "prim_closest_hit")
    return Hit(out_t.reshape(shape), Vec3(*(c.reshape(shape) for c in out_n)),
               out_m.reshape(shape))


def prim_any_hit(prims: PrimRows, ray: Ray, t_min, limit) -> torch.Tensor:
    """True where some prim lies at t in [t_min, limit) (``limit`` a number
    or a tensor that broadcasts against the lanes): ``_prim_best(...).time <
    limit``. Lanes with ``limit <= t_min`` are False. CPU rays take
    `prim_any_hit_plain`; CUDA rays launch K-prim once, which stops a lane
    at its first prim before ``limit``."""
    _check_rows("prim_any_hit", prims)
    comps, shape = _lanes("prim_any_hit", prims.rows, ray)
    if comps[0].device.type == "cpu":
        return prim_any_hit_plain(prims, ray, t_min, limit)
    _on_card("prim_any_hit", comps, prims.rows)
    n, dev = comps[0].shape[0], comps[0].device
    limit = _lane_tensor("prim_any_hit", "limit", limit, DTYPE, shape, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        p = _params(prims, comps, t_min)
        p.limit, p.limit_stride, p.out_hit = limit.data_ptr(), limit.stride(0), out.data_ptr()
        code = _build.library().lib.rpt_prim_any_hit(ctypes.byref(p), _build.stream_of(out))
        prim_any_hit.launches += 1
        _build.check(code, "prim_any_hit")
    return out.reshape(shape)


prim_closest_hit.launches = 0
prim_any_hit.launches = 0
