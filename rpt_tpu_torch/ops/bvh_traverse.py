"""Mesh BVH traversal: closest hit (K1) and any hit (K2).

The JAX package traverses meshes with XLA programs, not Pallas:
`rpt_tpu/intersect.py::_traverse` (:457) is the exact spec, and the TPU
engines `tiled.py` and `deferred.py` reproduce its results. The port's
plain version is `_traverse` below, a step loop in torch ops over the
tables of `accel.bvh.pack_bvh` (its leaves tested by the dense test's
`leaf_rows_test`); the kernels are `csrc/bvh_traverse.cu`: a block packs
the lanes that enter into a list and its threads take one ray each.

`bvh_closest_hit` and `bvh_any_hit` are the wrappers: for tensors on the
CPU they run the plain version; for CUDA tensors they launch the kernel
(`_build.launch`) or raise. `traverse_counts` launches the counting
variants (steps and leaf slots per lane, the warps' live-lane share) for
the smoke run and the profile tool.

Rays arrive as (N, 3) float32 origins and directions; ``limit``,
``best_time`` are (N,) float32 and ``active`` an optional (N,) bool mask.
"""

from __future__ import annotations

import torch

from . import _build
from .dense_tri_hit import leaf_rows_test
from ..accel.bvh import LEAF_ROW, NODE_ROW, BVHTables
from ..dtypes import DTYPE, INF
from ..ray import Ray
from ..vec import Vec3

STACK = 64  # the kernels' traversal stack (bvh_traverse.cu kStack)
MAX_ROWS = 1 << 24  # row indices are stored as exact float32 integers


def _check_args(name, bvh, origin, direction, lanes: dict):
    n = origin.shape[0]
    dev = bvh.nodes.device
    for arg, t, shape, dtype in (("origin", origin, (n, 3), DTYPE),
                                 ("direction", direction, (n, 3), DTYPE),
                                 *((k, v, (n,), dt) for k, (v, dt) in lanes.items() if v is not None)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, the BVH on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t, width in (("nodes", bvh.nodes, NODE_ROW), ("leaves", bvh.leaves, LEAF_ROW)):
        if t.dim() != 2 or t.shape[1] != width or t.dtype != DTYPE or not t.is_contiguous():
            raise ValueError(f"{name}: bvh.{arg} must be contiguous float32 (rows, {width})")
        if t.shape[0] >= MAX_ROWS:
            raise ValueError(f"{name}: {t.shape[0]} {arg} rows; indices need < 2^24")
        if t.device != dev:
            raise ValueError(f"{name}: bvh.{arg} is on {t.device}, bvh.nodes on {dev}")
    if bvh.nodes.data_ptr() % 16 or bvh.leaves.data_ptr() % 16:
        raise ValueError(f"{name}: bvh.nodes and bvh.leaves must be 16-byte aligned")
    if bvh.stack_depth > STACK:
        raise ValueError(f"{name}: the tree needs a stack of {bvh.stack_depth}, "
                         f"the kernel has {STACK}")


def _ray(origin, direction) -> Ray:
    return Ray(Vec3(origin[:, 0], origin[:, 1], origin[:, 2]),
               Vec3(direction[:, 0], direction[:, 1], direction[:, 2]))


# ---------------------------------------------------------------------------
# The plain version: the ordered short-stack traversal in torch ops


def _leaf_intersect(leaves, do_leaf, leaf_idx, count, ray: Ray, t_min, time, tri, bu, bv, bw):
    """Test the leaf row ``leaf_idx`` of the lanes where ``do_leaf``
    (`rpt_tpu/intersect.py:370`). Only those lanes are gathered and
    tested; the others keep their state, as the JAX package's masked test
    leaves it."""
    lanes = torch.nonzero(do_leaf).squeeze(1)
    if lanes.numel() == 0:
        return time, tri, bu, bv, bw
    sub = Ray(ray.origin[lanes], ray.dir[lanes])
    out = leaf_rows_test(leaves[leaf_idx[lanes]], count[lanes], sub, t_min, time[lanes],
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


def bvh_closest_hit_plain(bvh, origin, direction, t_min: float, best_time, limit=None,
                          active=None):
    """The plain version of K1: `_traverse`."""
    return _traverse(bvh, _ray(origin, direction), t_min, INF if limit is None else limit,
                     best_time, False, active)


def bvh_any_hit_plain(bvh, origin, direction, t_min: float, limit, active=None):
    """The plain version of K2: `_traverse(any_hit=True)`."""
    inf = torch.full_like(limit, INF)
    time = _traverse(bvh, _ray(origin, direction), t_min, limit, inf, True, active)[0]
    return time < limit


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count_buffers(n: int, dev, count: bool):
    """The counting variant's zeroed outputs: per-lane (steps, leaf slots)
    and the warps' two sums; ``(None, None)`` without ``count``."""
    if not count:
        return None, None
    return (torch.zeros((n, 2), dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int64, device=dev))


# ---------------------------------------------------------------------------
# The kernels


def _launch_closest(name, bvh, origin, direction, t_min, best_time, limit=None, active=None,
                    count: bool = False):
    """Launch K1 (its counting variant with ``count``) for the wrapper
    ``name``: the five outputs and ``(ray_counts, warp_counts)``."""
    n, dev = origin.shape[0], origin.device
    out_t = torch.empty(n, dtype=DTYPE, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    out_u, out_v, out_w = (torch.empty(n, dtype=DTYPE, device=dev) for _ in range(3))
    counts = _count_buffers(n, dev, count)
    _build.launch(name, "rpt_bvh_closest_hit", origin, origin.data_ptr(), direction.data_ptr(),
                  n, bvh.nodes.data_ptr(), bvh.leaves.data_ptr(), float(t_min), _ptr(limit),
                  best_time.data_ptr(), _ptr(active), out_t.data_ptr(), out_tri.data_ptr(),
                  out_u.data_ptr(), out_v.data_ptr(), out_w.data_ptr(), _ptr(counts[0]),
                  _ptr(counts[1]))
    return (out_t, out_tri, out_u, out_v, out_w), counts


def _launch_any(name, bvh, origin, direction, t_min, limit, active=None, count: bool = False):
    """Launch K2 (its counting variant with ``count``) for the wrapper
    ``name``: the flags and ``(ray_counts, warp_counts)``."""
    n, dev = origin.shape[0], origin.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    counts = _count_buffers(n, dev, count)
    _build.launch(name, "rpt_bvh_any_hit", origin, origin.data_ptr(), direction.data_ptr(), n,
                  bvh.nodes.data_ptr(), bvh.leaves.data_ptr(), float(t_min), limit.data_ptr(),
                  _ptr(active), out.data_ptr(), _ptr(counts[0]), _ptr(counts[1]))
    return out, counts


def bvh_closest_hit(bvh, origin, direction, t_min: float, best_time, limit=None, active=None):
    """Nearest triangle per ray with t in [t_min, min(best_time, limit)):
    ``(t, tri, u, v, w)``, (N,) float32 / int32 / float32 x3; where there
    is none, ``best_time``, -1 and zeros. CPU tensors take
    `bvh_closest_hit_plain`; CUDA tensors launch K1."""
    _check_args("bvh_closest_hit", bvh, origin, direction,
                {"best_time": (best_time, DTYPE), "limit": (limit, DTYPE),
                 "active": (active, torch.bool)})
    if origin.device.type == "cpu":
        return bvh_closest_hit_plain(bvh, origin, direction, t_min, best_time, limit, active)
    _build.on_card("bvh_closest_hit", origin)
    return _launch_closest("bvh_closest_hit", bvh, origin, direction, t_min, best_time, limit,
                           active)[0]


def bvh_any_hit(bvh, origin, direction, t_min: float, limit, active=None):
    """True where some triangle lies at t in [t_min, limit): (N,) bool.
    Lanes with ``limit <= t_min`` or ``active`` False are False. CPU
    tensors take `bvh_any_hit_plain`; CUDA tensors launch K2."""
    _check_args("bvh_any_hit", bvh, origin, direction,
                {"limit": (limit, DTYPE), "active": (active, torch.bool)})
    if origin.device.type == "cpu":
        return bvh_any_hit_plain(bvh, origin, direction, t_min, limit, active)
    _build.on_card("bvh_any_hit", origin)
    return _launch_any("bvh_any_hit", bvh, origin, direction, t_min, limit, active)[0]


def traverse_counts(any_hit: bool, bvh, origin, direction, t_min: float, *args, **kwargs):
    """The counting variant of K1 (``any_hit`` False; the arguments of
    `bvh_closest_hit`) or K2 (True; those of `bvh_any_hit`), on the card:
    ``(ray_counts, live_share)``. ``ray_counts`` is (N, 2) int32, the steps
    and the leaf slots tested per lane (0 for a lane that never entered);
    ``live_share`` is the steps the rays took over what the kernel's warps
    spent in lockstep (32 lanes x their longest ray)."""
    _build.on_card("traverse_counts", origin)
    launch = _launch_any if any_hit else _launch_closest
    _, (ray_counts, warp_counts) = launch("traverse_counts", bvh, origin, direction, t_min,
                                          *args, **kwargs, count=True)
    live, lockstep = warp_counts.tolist()
    return ray_counts, live / max(lockstep, 1)
