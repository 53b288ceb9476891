"""Vectorized ray-primitive intersection and scene closest hit — port of
`rpt_tpu/intersect.py` (`rpt/src/shape/*.rs`).

Every function takes a batch of N rays and tests it against one primitive
batch (analytic prims, looped per prim) or the scene's triangles.
Scene-level closest hit is the reference's deliberate linear scan over
objects (`renderer.rs:411-425`), here a masked min over the per-type
batches. The analytic prims go through the wrappers of
`rpt_tpu_torch.ops.prim_hit`: the hand-written kernel K-prim (one launch
a query over every prim of the scene) on a CUDA tensor, and the per-type
intersectors below, its spec, on a CPU tensor.

Triangles: meshes of at most ``DENSE_TRI_ROWS`` packed leaf rows are
tested densely (every row against the wavefront), as the JAX package does
(`dense_tri_hit`), through the wrappers of `rpt_tpu_torch.ops.dense_tri_hit`:
the hand-written kernel K-dense on a CUDA tensor, and `dense_tri_hit_plain`,
the chain of torch ops that is its spec, on a CPU tensor. Bigger meshes go
through the BVH traversal wrappers of `rpt_tpu_torch.ops.bvh_traverse`: the
hand-written kernels (closest hit K1, any hit K2) on a CUDA tensor, and
`_traverse`, the plain ordered short-stack traversal that is their spec, on
a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import tracing
from .dtypes import DTYPE, EPS, INF
from .ops import bvh_traverse as kernels
from .ops import dense_tri_hit as dense
from .ops import prim_hit
from .ray import Hit, Ray, closer
from .vec import Affine, Mat3, Vec3, where


# ---------------------------------------------------------------------------
# Compiled geometry tables (built by rpt_tpu_torch.scene)


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


# Packed-row layout of `rpt_tpu_torch.accel.bvh.pack_bvh` (the JAX
# package's layout, `rpt_tpu/intersect.py:77-92`).
NODE_ROW = 16
LEAF_TRIS = 8
LEAF_ROW = 80
# leaf row: 10 component blocks of 8 slots
#   [v1.x*8][v1.y*8][v1.z*8][e1.x*8][e1.y*8][e1.z*8][e2.x*8][e2.y*8][e2.z*8][id*8]
SHADE_ROW = 12  # [n1.xyz, n2.xyz, n3.xyz, material, pad, pad]
DENSE_TRI_ROWS = 8  # meshes with <= 8 leaf rows (64 tris) are tested densely


@dataclass(frozen=True)
class BVHTables:
    """Pair-packed BVH tables (``pack_bvh``): ``nodes`` (K, NODE_ROW),
    ``leaves`` (L, LEAF_ROW) and ``shade`` (T, SHADE_ROW) float32, and the
    exact traversal stack bound."""

    nodes: torch.Tensor
    leaves: torch.Tensor
    shade: torch.Tensor
    stack_depth: int = 48


# ---------------------------------------------------------------------------
# Per-type intersectors. Convention: return a Hit (time=inf on miss); the
# caller merges with `closer`.


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
        b_min, b_max = _aabb_interval(
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


def _slab_interval(o: Vec3, inv: Vec3, p_min: Vec3, p_max: Vec3):
    """NaN-safe slab interval (kdtree.rs:57-71): an axis whose 0*inf gives
    NaN does not constrain."""
    t1 = (p_min - o) * inv
    t2 = (p_max - o) * inv
    lo = t1.minimum(t2).map(lambda c: torch.where(torch.isnan(c), -INF, c))
    hi = t1.maximum(t2).map(lambda c: torch.where(torch.isnan(c), INF, c))
    return lo.max_component(), hi.min_component()


def _aabb_interval(ray: Ray, p_min: Vec3, p_max: Vec3):
    inv = ray.dir.map(torch.reciprocal)
    return _slab_interval(ray.origin, inv, p_min, p_max)


# ---------------------------------------------------------------------------
# Triangles


def _origin_on_plane(num, pn, v1, o):
    """True where the ray origin lies within f32 rounding of a triangle's
    supporting plane (`rpt_tpu/intersect.py:347-367`). Without it, grazing
    rays between two points on a mesh floor are spuriously self-occluded
    (50.7% of noisy floor-photon visibility rechecks in the JAX package's
    round-4 repro). The scale is the L1 magnitude of the points: a
    computed coordinate carries absolute noise ~eps*||o||."""
    scale = (
        torch.abs(o.x) + torch.abs(o.y) + torch.abs(o.z)
        + torch.abs(v1.x) + torch.abs(v1.y) + torch.abs(v1.z)
    )
    return torch.abs(num) <= (32.0 * EPS) * scale


def _leaf_rows_test(leaf, count, ray: Ray, t_min, time, tri, bu, bv, bw):
    """Test the 8 triangle slots of (m, LEAF_ROW) rows (m = 1 broadcasts
    one row against every ray), vectorized across the slot axis; ``count``
    (an int, or an (n,) tensor) bounds the slots tested. Same algebra as
    mesh.rs:50-83 with e1 = v2-v1, e2 = v3-v1; the best slot per lane is
    the first minimum (``torch.min`` returns its index), so ties go to the
    lowest slot."""
    leaf3 = leaf.reshape(leaf.shape[0], 10, leaf.shape[1] // 10)

    def vec(c0):
        return Vec3(leaf3[:, c0, :], leaf3[:, c0 + 1, :], leaf3[:, c0 + 2, :])

    v1, e1, e2 = vec(0), vec(3), vec(6)
    tri_id = leaf3[:, 9, :].to(torch.int32)

    o = ray.origin.map(lambda c: c[:, None])
    d = ray.dir.map(lambda c: c[:, None])

    pn = e1.cross(e2).normalize()
    cosine = pn.dot(d)
    num = pn.dot(v1 - o)
    t = num / cosine
    slot_ids = torch.arange(t.shape[1], device=t.device)[None, :]
    if isinstance(count, torch.Tensor):
        count = count[:, None]
    ok = (
        (torch.abs(cosine) >= 1e-8)
        & ~_origin_on_plane(num, pn, v1, o)
        & (t >= t_min)
        & (t < time[:, None])
        & (tri_id >= 0)
        & (slot_ids < count)
    )
    p = o + d * t
    d2 = p - v1
    d00 = e1.dot(e1)
    d01 = e1.dot(e2)
    d11 = e2.dot(e2)
    d20 = d2.dot(e1)
    d21 = d2.dot(e2)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    ok = ok & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)

    t_masked = torch.where(ok, t, INF)
    best, slot = torch.min(t_masked, dim=1)
    slot = slot[:, None]

    def pick(x):
        return x.expand(t_masked.shape).gather(1, slot)[:, 0]

    better = best < time
    return (
        torch.where(better, best, time),
        torch.where(better, pick(tri_id), tri),
        torch.where(better, pick(u), bu),
        torch.where(better, pick(v), bv),
        torch.where(better, pick(w), bw),
    )


def dense_tri_hit_plain(bvh: BVHTables, ray: Ray, t_min, best: Hit) -> Hit:
    """Closest triangle hit for tiny meshes: every leaf row broadcast
    against the wavefront, no traversal (`rpt_tpu/intersect.py:652`). The
    plain version of K-dense (`ops/dense_tri_hit.py`)."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    time = best.time
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    z = torch.zeros(n, dtype=DTYPE, device=dev)
    bu = bv = bw = z
    for row_i in range(bvh.leaves.shape[0]):
        time, tri, bu, bv, bw = _leaf_rows_test(
            bvh.leaves[row_i : row_i + 1], LEAF_TRIS, ray, t_min, time, tri, bu, bv, bw
        )
    return _finish_hit(bvh, best, time, tri, bu, bv, bw)


def _finish_hit(bvh: BVHTables, best: Hit, time, tri, u, v, w) -> Hit:
    improved = time < best.time
    srow = bvh.shade[torch.clamp(tri, min=0).long()]
    n1 = Vec3(srow[:, 0], srow[:, 1], srow[:, 2])
    n2 = Vec3(srow[:, 3], srow[:, 4], srow[:, 5])
    n3 = Vec3(srow[:, 6], srow[:, 7], srow[:, 8])
    normal = (n1 * u + n2 * v + n3 * w).normalize()
    mat = srow[:, 9].to(torch.int32)
    return Hit(
        torch.where(improved, time, best.time),
        where(improved, normal, best.normal),
        torch.where(improved, mat, best.material),
    )


# ---------------------------------------------------------------------------
# BVH traversal: the plain version of kernels K1 and K2


def _leaf_intersect(leaves, do_leaf, leaf_idx, count, ray: Ray, t_min, time, tri, bu, bv, bw):
    """Test the leaf row ``leaf_idx`` of the lanes where ``do_leaf``
    (`rpt_tpu/intersect.py:370`). Only those lanes are gathered and
    tested; the others keep their state, as the JAX package's masked test
    leaves it."""
    lanes = torch.nonzero(do_leaf).squeeze(1)
    if lanes.numel() == 0:
        return time, tri, bu, bv, bw
    sub = Ray(ray.origin[lanes], ray.dir[lanes])
    out = _leaf_rows_test(leaves[leaf_idx[lanes]], count[lanes], sub, t_min, time[lanes],
                          tri[lanes], bu[lanes], bv[lanes], bw[lanes])
    res = []
    for full, part in zip((time, tri, bu, bv, bw), out):
        full = full.clone()
        full[lanes] = part
        res.append(full)
    return tuple(res)


def _traverse_step(state, ray: Ray, o6, inv6, limit, nodes, leaves, t_min, any_hit: bool):
    """One step of the ordered short-stack traversal (`rpt_tpu/intersect.py:
    569-646`): fetch the node row of ``cur`` (both children's boxes), test
    both children, test their leaves (left, then right), descend into the
    nearer internal child and push the farther one; pop when neither is
    entered. With ``any_hit`` a lane retires after the step in which it
    finds a hit before ``limit``."""
    cur, sp, stack, time, tri, bu, bv, bw = state
    n = cur.shape[0]
    active = cur >= 0
    row = nodes[torch.clamp(cur, min=0)]

    t1 = (row[:, 0:6] - o6) * inv6
    t2 = (row[:, 6:12] - o6) * inv6
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    # an origin on a slab plane with a zero direction component gives
    # 0 * inf = NaN: that axis does not constrain
    lo = torch.where(torch.isnan(lo), -INF, lo)
    hi = torch.where(torch.isnan(hi), INF, hi)
    enter = lo.reshape(n, 2, 3).amax(-1)
    exit_ = hi.reshape(n, 2, 3).amin(-1)

    pm = row[:, 12:16].to(torch.int64)  # [Lptr, Rptr, Lmeta, Rmeta], exact small floats
    ptr, meta = pm[:, 0:2], pm[:, 2:4]
    cutoff = torch.minimum(time, limit)
    hit2 = ((enter <= exit_) & (exit_ >= t_min) & (enter <= cutoff[:, None]) & (meta >= 0)
            & active[:, None])
    l_hit, r_hit = hit2[:, 0], hit2[:, 1]
    lptr, rptr = ptr[:, 0], ptr[:, 1]
    lmeta, rmeta = meta[:, 0], meta[:, 1]

    time, tri, bu, bv, bw = _leaf_intersect(leaves, l_hit & (lmeta > 0), lptr, lmeta, ray,
                                            t_min, time, tri, bu, bv, bw)
    time, tri, bu, bv, bw = _leaf_intersect(leaves, r_hit & (rmeta > 0), rptr, rmeta, ray,
                                            t_min, time, tri, bu, bv, bw)

    want_l = l_hit & (lmeta == 0)
    want_r = r_hit & (rmeta == 0)
    both = want_l & want_r
    l_near = enter[:, 0] <= enter[:, 1]
    first = torch.where(want_l & (~want_r | l_near), lptr, rptr)
    second = torch.where(l_near, rptr, lptr)

    # the stack is sized by the tree's exact depth bound (pack_bvh), so a
    # push never finds it full; the guard only keeps the step well defined
    depth = stack.shape[1]
    rows = torch.arange(n, device=cur.device)
    can_push = both & (sp < depth)
    stack[rows[can_push], sp[can_push]] = second[can_push]
    sp_after = sp + can_push.to(sp.dtype)
    descend = want_l | want_r
    do_pop = active & ~descend
    popped = stack[rows, torch.clamp(sp_after - 1, 0, depth - 1)]
    pop_ok = (sp_after > 0) & (sp_after <= depth)
    minus1 = torch.full_like(cur, -1)
    new_cur = torch.where(~active, cur,
                          torch.where(descend, first, torch.where(pop_ok, popped, minus1)))
    new_sp = torch.where(do_pop, torch.clamp(sp_after - 1, min=0), sp_after)
    if any_hit:
        new_cur = torch.where(time < limit, minus1, new_cur)
    return new_cur, new_sp, stack, time, tri, bu, bv, bw


def _traverse(bvh: BVHTables, ray: Ray, t_min, limit, best_time, any_hit: bool, active=None):
    """Ordered short-stack traversal over the pair-packed tables
    (`rpt_tpu/intersect.py:457`), the plain version of kernels K1 and K2:
    ``while any(cur >= 0)`` step the live lanes. Returns ``(time, tri, u,
    v, w)``: the nearest triangle in [t_min, min(best_time, limit)), or
    ``best_time`` and tri -1 where there is none. Lanes whose ``limit``
    admits no hit (``limit <= t_min``, e.g. -1) or that ``active`` masks
    off never enter. The JAX package's staged argsort compaction
    (``COMPACT_STAGES``) is TPU scheduling and is left out: finished lanes
    stay in the loop, inactive."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    limit = torch.as_tensor(limit, dtype=DTYPE, device=dev).expand(n)
    out = [best_time.clone(), torch.full((n,), -1, dtype=torch.int32, device=dev),
           torch.zeros(n, dtype=DTYPE, device=dev), torch.zeros(n, dtype=DTYPE, device=dev),
           torch.zeros(n, dtype=DTYPE, device=dev)]
    live0 = limit > t_min
    if active is not None:
        live0 = live0 & active
    lanes = torch.nonzero(live0).squeeze(1)
    m = lanes.numel()
    if m == 0:
        return tuple(out)
    sub = Ray(ray.origin[lanes], ray.dir[lanes])
    o6 = torch.cat([sub.origin.to_array()] * 2, dim=1)
    inv6 = torch.cat([(1.0 / sub.dir.to_array())] * 2, dim=1)
    sub_limit = limit[lanes]
    state = [torch.zeros(m, dtype=torch.int64, device=dev),
             torch.zeros(m, dtype=torch.int64, device=dev),
             torch.zeros((m, bvh.stack_depth), dtype=torch.int64, device=dev),
             best_time[lanes], out[1][lanes], out[2][lanes], out[3][lanes], out[4][lanes]]
    while bool((state[0] >= 0).any()):
        state = _traverse_step(state, sub, o6, inv6, sub_limit, bvh.nodes, bvh.leaves,
                               t_min, any_hit)
    for full, part in zip(out, state[3:]):
        full[lanes] = part
    return tuple(out)


def bvh_closest_hit(bvh: BVHTables, ray: Ray, t_min, best: Hit) -> Hit:
    """Closest triangle hit closer than ``best`` (`rpt_tpu/intersect.py:
    699`, without the TPU's tiled and deferred engines): the dense test for
    tiny meshes (K-dense on a CUDA tensor, `dense_tri_hit_plain` on a CPU
    tensor), else the traversal (K1 on a CUDA tensor, `_traverse` on a CPU
    tensor), then the shading attributes of the winner."""
    if bvh.leaves.shape[0] <= DENSE_TRI_ROWS:
        return dense.dense_closest_hit(bvh, ray, t_min, best)
    time, tri, u, v, w = kernels.bvh_closest_hit(
        bvh, ray.origin.to_array().contiguous(), ray.dir.to_array().contiguous(), t_min,
        best.time.contiguous())
    return _finish_hit(bvh, best, time, tri, u, v, w)


def bvh_any_hit(bvh: BVHTables, ray: Ray, t_min, limit, skip=None) -> torch.Tensor:
    """True where some triangle lies at t in [t_min, limit)
    (`rpt_tpu/intersect.py:767`): the early-exit occlusion query (for tiny
    meshes the dense test, K-dense on a CUDA tensor; else K2 on a CUDA
    tensor, `_traverse(any_hit=True)` on a CPU tensor). Lanes in ``skip``
    are already known occluded: both leave them out (their result is
    False)."""
    if bvh.leaves.shape[0] <= DENSE_TRI_ROWS:
        return dense.dense_any_hit(bvh, ray, t_min, limit, skip)
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    limit = torch.as_tensor(limit, dtype=DTYPE, device=dev).expand(n).contiguous()
    return kernels.bvh_any_hit(bvh, ray.origin.to_array().contiguous(),
                               ray.dir.to_array().contiguous(), t_min, limit,
                               None if skip is None else ~skip)


# ---------------------------------------------------------------------------
# Scene-level queries


def _prim_best(scene, tables, ray: Ray, t_min) -> Hit:
    """Closest hit over the analytic primitive batches: K-prim on a CUDA
    tensor, one launch; the per-type chain on a CPU tensor
    (`ops/prim_hit.py`)."""
    return prim_hit.prim_closest_hit(scene.prim_rows, ray, t_min)


def closest_hit(scene, tables, ray: Ray, t_min=None) -> Hit:
    """Masked min over all primitive batches and the triangles — the
    wavefront analog of `Renderer::get_closest_hit` (renderer.rs:416-425).
    Its span, ``intersect.closest``, holds K-prim and K1 or K-dense."""
    if t_min is None:
        t_min = scene.t_min
    with tracing.span("intersect.closest"):
        best = _prim_best(scene, tables, ray, t_min)
        if scene.n_tris:
            best = bvh_closest_hit(tables["bvh"], ray, t_min, best)
    return best


def prim_occluded(scene, tables, ray: Ray, limit, t_min=None) -> torch.Tensor:
    """Occlusion by the analytic primitives only; the mesh is not tested
    (`rpt_tpu/intersect.py:846`): ``_prim_best(...).time < limit``, K-prim's
    any-hit entry on a CUDA tensor. Its span is ``intersect.occluded``."""
    if t_min is None:
        t_min = scene.t_min
    with tracing.span("intersect.occluded"):
        return prim_hit.prim_any_hit(scene.prim_rows, ray, t_min, limit)


def occluded(scene, tables, ray: Ray, limit, t_min=None) -> torch.Tensor:
    """True where any geometry lies at t in [t_min, limit) along the ray —
    the shadow query (lanes with limit -1 are never occluded). Lanes an
    analytic primitive already occludes skip the mesh test. Its span,
    ``intersect.occluded``, holds K-prim and K2 or K-dense."""
    if t_min is None:
        t_min = scene.t_min
    with tracing.span("intersect.occluded"):
        occ = prim_hit.prim_any_hit(scene.prim_rows, ray, t_min, limit)
        if scene.n_tris:
            occ = occ | bvh_any_hit(tables["bvh"], ray, t_min, limit, skip=occ)
    return occ
