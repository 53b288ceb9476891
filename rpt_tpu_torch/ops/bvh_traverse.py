"""Mesh BVH traversal: closest hit (K1) and any hit (K2).

The JAX package traverses meshes with XLA programs, not Pallas:
`rpt_tpu/intersect.py::_traverse` (:457) is the exact spec, and the TPU
engines `tiled.py` and `deferred.py` reproduce its results. The port's
plain version is `rpt_tpu_torch.intersect._traverse`, a step loop in torch
ops; the kernels are `csrc/bvh_traverse.cu`, one thread per ray.

`bvh_closest_hit` and `bvh_any_hit` are the wrappers: for tensors on the
CPU they run the plain version; for CUDA tensors they launch the kernel or
raise. ``bvh_closest_hit.launches`` and ``bvh_any_hit.launches`` count
kernel launches.

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
    if bvh.nodes.data_ptr() % 16:
        raise ValueError(f"{name}: bvh.nodes must be 16-byte aligned")
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
    n = origin.shape[0]
    out_t = torch.empty(n, dtype=DTYPE, device=origin.device)
    out_tri = torch.empty(n, dtype=torch.int32, device=origin.device)
    out_u, out_v, out_w = (torch.empty(n, dtype=DTYPE, device=origin.device) for _ in range(3))
    lib = _build.library().lib
    code = lib.rpt_bvh_closest_hit(
        origin.data_ptr(), direction.data_ptr(), n, bvh.nodes.data_ptr(), bvh.leaves.data_ptr(),
        float(t_min), None if limit is None else limit.data_ptr(), best_time.data_ptr(),
        None if active is None else active.data_ptr(), out_t.data_ptr(), out_tri.data_ptr(),
        out_u.data_ptr(), out_v.data_ptr(), out_w.data_ptr(), _build.stream_of(origin),
    )
    bvh_closest_hit.launches += 1
    _build.check(code, "bvh_closest_hit")
    return out_t, out_tri, out_u, out_v, out_w


def bvh_any_hit(bvh, origin, direction, t_min: float, limit, active=None):
    """True where some triangle lies at t in [t_min, limit): (N,) bool.
    Lanes with ``limit <= t_min`` or ``active`` False are False. CPU
    tensors take `bvh_any_hit_plain`; CUDA tensors launch K2."""
    _check_args("bvh_any_hit", bvh, origin, direction,
                {"limit": (limit, DTYPE), "active": (active, torch.bool)})
    if origin.device.type == "cpu":
        return bvh_any_hit_plain(bvh, origin, direction, t_min, limit, active)
    _device("bvh_any_hit", origin)
    n = origin.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=origin.device)
    lib = _build.library().lib
    code = lib.rpt_bvh_any_hit(
        origin.data_ptr(), direction.data_ptr(), n, bvh.nodes.data_ptr(), bvh.leaves.data_ptr(),
        float(t_min), limit.data_ptr(), None if active is None else active.data_ptr(),
        out.data_ptr(), _build.stream_of(origin),
    )
    bvh_any_hit.launches += 1
    _build.check(code, "bvh_any_hit")
    return out


bvh_closest_hit.launches = 0
bvh_any_hit.launches = 0
