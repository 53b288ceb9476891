"""Mesh BVH traversal: closest hit (K1) and any hit (K2).

The JAX package traverses meshes with XLA programs, not Pallas:
`rpt_tpu/intersect.py::_traverse` (:457) is the exact spec, and the TPU
engines `tiled.py` and `deferred.py` reproduce its results. The port's
plain version is `rpt_tpu_torch.intersect._traverse`, a step loop in torch
ops; the kernels are `csrc/bvh_traverse.cu`: a block packs the lanes that
enter into a list and its threads take one ray each.

`bvh_closest_hit` and `bvh_any_hit` are the wrappers: for tensors on the
CPU they run the plain version; for CUDA tensors they launch the kernel or
raise. ``bvh_closest_hit.launches`` and ``bvh_any_hit.launches`` count
kernel launches. `traverse_counts` launches the counting variants (steps
and leaf slots per lane, the warps' live-lane share) for the smoke run and
the profile tool.

Rays arrive as (N, 3) float32 origins and directions; ``limit``,
``best_time`` are (N,) float32 and ``active`` an optional (N,) bool mask.
"""

from __future__ import annotations

import torch

from . import _build
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
    for arg, t, width in (("nodes", bvh.nodes, 16), ("leaves", bvh.leaves, 80)):
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


def bvh_closest_hit_plain(bvh, origin, direction, t_min: float, best_time, limit=None,
                          active=None):
    """The plain version of K1: `intersect._traverse`."""
    from ..intersect import _traverse

    return _traverse(bvh, _ray(origin, direction), t_min, INF if limit is None else limit,
                     best_time, False, active)


def bvh_any_hit_plain(bvh, origin, direction, t_min: float, limit, active=None):
    """The plain version of K2: `intersect._traverse(any_hit=True)`."""
    from ..intersect import _traverse

    inf = torch.full_like(limit, INF)
    time = _traverse(bvh, _ray(origin, direction), t_min, limit, inf, True, active)[0]
    return time < limit


def _device(name, origin):
    if origin.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {origin.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count_buffers(n: int, dev, count: bool):
    """The counting variant's zeroed outputs: per-lane (steps, leaf slots)
    and the warps' two sums; ``(None, None)`` without ``count``."""
    if not count:
        return None, None
    return (torch.zeros((n, 2), dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int64, device=dev))


def _launch_closest(bvh, origin, direction, t_min, best_time, limit=None, active=None,
                    count: bool = False):
    """Launch K1 (its counting variant with ``count``): the status, the
    five outputs and ``(ray_counts, warp_counts)``."""
    n, dev = origin.shape[0], origin.device
    out_t = torch.empty(n, dtype=DTYPE, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    out_u, out_v, out_w = (torch.empty(n, dtype=DTYPE, device=dev) for _ in range(3))
    counts = _count_buffers(n, dev, count)
    code = _build.library().lib.rpt_bvh_closest_hit(
        origin.data_ptr(), direction.data_ptr(), n, bvh.nodes.data_ptr(), bvh.leaves.data_ptr(),
        float(t_min), _ptr(limit), best_time.data_ptr(), _ptr(active), out_t.data_ptr(),
        out_tri.data_ptr(), out_u.data_ptr(), out_v.data_ptr(), out_w.data_ptr(),
        _ptr(counts[0]), _ptr(counts[1]), _build.stream_of(origin),
    )
    return code, (out_t, out_tri, out_u, out_v, out_w), counts


def _launch_any(bvh, origin, direction, t_min, limit, active=None, count: bool = False):
    """Launch K2 (its counting variant with ``count``)."""
    n, dev = origin.shape[0], origin.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    counts = _count_buffers(n, dev, count)
    code = _build.library().lib.rpt_bvh_any_hit(
        origin.data_ptr(), direction.data_ptr(), n, bvh.nodes.data_ptr(), bvh.leaves.data_ptr(),
        float(t_min), limit.data_ptr(), _ptr(active), out.data_ptr(), _ptr(counts[0]),
        _ptr(counts[1]), _build.stream_of(origin),
    )
    return code, out, counts


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
    _device("bvh_closest_hit", origin)
    code, out, _ = _launch_closest(bvh, origin, direction, t_min, best_time, limit, active)
    bvh_closest_hit.launches += 1
    _build.check(code, "bvh_closest_hit")
    return out


def bvh_any_hit(bvh, origin, direction, t_min: float, limit, active=None):
    """True where some triangle lies at t in [t_min, limit): (N,) bool.
    Lanes with ``limit <= t_min`` or ``active`` False are False. CPU
    tensors take `bvh_any_hit_plain`; CUDA tensors launch K2."""
    _check_args("bvh_any_hit", bvh, origin, direction,
                {"limit": (limit, DTYPE), "active": (active, torch.bool)})
    if origin.device.type == "cpu":
        return bvh_any_hit_plain(bvh, origin, direction, t_min, limit, active)
    _device("bvh_any_hit", origin)
    code, out, _ = _launch_any(bvh, origin, direction, t_min, limit, active)
    bvh_any_hit.launches += 1
    _build.check(code, "bvh_any_hit")
    return out


def traverse_counts(any_hit: bool, bvh, origin, direction, t_min: float, *args, **kwargs):
    """The counting variant of K1 (``any_hit`` False; the arguments of
    `bvh_closest_hit`) or K2 (True; those of `bvh_any_hit`), on the card:
    ``(ray_counts, live_share)``. ``ray_counts`` is (N, 2) int32, the steps
    and the leaf slots tested per lane (0 for a lane that never entered);
    ``live_share`` is the steps the rays took over what the kernel's warps
    spent in lockstep (32 lanes x their longest ray). Counts no launch."""
    name = "bvh_any_hit" if any_hit else "bvh_closest_hit"
    _device(name, origin)
    launch = _launch_any if any_hit else _launch_closest
    code, _, (ray_counts, warp_counts) = launch(bvh, origin, direction, t_min, *args, **kwargs,
                                                count=True)
    _build.check(code, name + " (counting)")
    live, lockstep = warp_counts.tolist()
    return ray_counts, live / max(lockstep, 1)


bvh_closest_hit.launches = 0
bvh_any_hit.launches = 0
