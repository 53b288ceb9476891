"""Closest hit and any hit against a small triangle mesh (K-dense).

The JAX package tests a mesh of at most ``DENSE_TRI_ROWS`` packed leaf rows
densely, every row against every ray of the wavefront with no traversal,
in one XLA program (`rpt_tpu/intersect.py:652` ``dense_tri_hit``,
`_leaf_rows_test` `:376`, `_finish_hit` `:674`). The port's plain version
is `rpt_tpu_torch.intersect.dense_tri_hit_plain`: a chain of torch ops a
leaf row, then the shading gather. The kernel is `csrc/dense_tri_hit.cu`,
one thread a ray over every triangle, the rows in shared memory.

`dense_closest_hit` and `dense_any_hit` are the wrappers: for rays on the
CPU they run the plain version; for CUDA tensors they launch the kernel,
once a call, or raise. ``dense_closest_hit.launches`` and
``dense_any_hit.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .prim_hit import _lane_tensor, _lanes, _on_card
from ..dtypes import DTYPE
from ..ray import Hit
from ..vec import Vec3


def _check_tables(name: str, bvh) -> None:
    from ..intersect import DENSE_TRI_ROWS, LEAF_ROW, SHADE_ROW

    leaves, shade = bvh.leaves, bvh.shade
    for label, table, width in (("leaves", leaves, LEAF_ROW), ("shade", shade, SHADE_ROW)):
        if (table.dim() != 2 or table.shape[1] != width or table.dtype != DTYPE
                or not table.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous float32 (R, {width}), got "
                             f"{table.dtype} {tuple(table.shape)}")
    if leaves.shape[0] > DENSE_TRI_ROWS:
        raise ValueError(f"{name}: {leaves.shape[0]} leaf rows; the dense test takes at most "
                         f"{DENSE_TRI_ROWS}")
    if shade.device != leaves.device:
        raise ValueError(f"{name}: the shade rows are on {shade.device}, the leaves on "
                         f"{leaves.device}")


# ---------------------------------------------------------------------------
# The plain version: the chain of torch ops of `rpt_tpu_torch.intersect`


def dense_any_hit_plain(bvh, ray, t_min, limit, skip=None) -> torch.Tensor:
    """True where some triangle lies at t in [t_min, limit): the chain's
    closest time from no hit, against ``limit``; lanes in ``skip`` read
    False."""
    from ..intersect import dense_tri_hit_plain

    shape, dev = ray.origin.x.shape, ray.origin.x.device
    hit = dense_tri_hit_plain(bvh, ray, t_min, Hit.none(shape, dev)).time < limit
    return hit if skip is None else hit & ~skip


# ---------------------------------------------------------------------------
# The kernel


class _DenseParams(ctypes.Structure):
    """`csrc/dense_tri_hit.cu` DenseParams, passed by value to the kernel."""

    _fields_ = [("ray", ctypes.c_void_p * 6), ("stride", ctypes.c_int64 * 6),
                ("leaves", ctypes.c_void_p), ("shade", ctypes.c_void_p),
                ("best_t", ctypes.c_void_p), ("best_normal", ctypes.c_void_p * 3),
                ("best_material", ctypes.c_void_p), ("best_stride", ctypes.c_int64 * 5),
                ("limit", ctypes.c_void_p), ("limit_stride", ctypes.c_int64),
                ("skip", ctypes.c_void_p), ("skip_stride", ctypes.c_int64),
                ("out_t", ctypes.c_void_p), ("out_normal", ctypes.c_void_p),
                ("out_material", ctypes.c_void_p), ("out_hit", ctypes.c_void_p),
                ("n", ctypes.c_int), ("rows", ctypes.c_int), ("t_min", ctypes.c_float)]


def _params(bvh, comps, t_min) -> _DenseParams:
    p = _DenseParams()
    for k, c in enumerate(comps):
        p.ray[k], p.stride[k] = c.data_ptr(), c.stride(0)
    p.leaves, p.shade = bvh.leaves.data_ptr(), bvh.shade.data_ptr()
    p.n, p.rows, p.t_min = comps[0].shape[0], bvh.leaves.shape[0], float(t_min)
    return p


def dense_closest_hit(bvh, ray, t_min, best: Hit) -> Hit:
    """The nearest triangle hit per ray in [t_min, best.time), merged into
    ``best``: where the mesh is nearer, its time, interpolated normal and
    material; elsewhere ``best`` unchanged. CPU rays take
    `dense_tri_hit_plain`; CUDA rays launch K-dense once."""
    from ..intersect import dense_tri_hit_plain

    _check_tables("dense_closest_hit", bvh)
    comps, shape = _lanes("dense_closest_hit", bvh.leaves, ray)
    if comps[0].device.type == "cpu":
        return dense_tri_hit_plain(bvh, ray, t_min, best)
    _on_card("dense_closest_hit", comps)
    n, dev = comps[0].shape[0], comps[0].device
    ins = [_lane_tensor("dense_closest_hit", "best", x, dtype, shape, dev)
           for x, dtype in ((best.time, DTYPE), (best.normal.x, DTYPE), (best.normal.y, DTYPE),
                            (best.normal.z, DTYPE), (best.material, torch.int32))]
    out_t = torch.empty(n, dtype=DTYPE, device=dev)
    out_n = torch.empty((3, n), dtype=DTYPE, device=dev)
    out_m = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        p = _params(bvh, comps, t_min)
        p.best_t, p.best_material = ins[0].data_ptr(), ins[4].data_ptr()
        for k in range(3):
            p.best_normal[k] = ins[1 + k].data_ptr()
        p.best_stride[:] = [x.stride(0) for x in ins]
        p.out_t, p.out_normal, p.out_material = (out_t.data_ptr(), out_n.data_ptr(),
                                                 out_m.data_ptr())
        code = _build.library().lib.rpt_dense_closest_hit(ctypes.byref(p),
                                                           _build.stream_of(out_t))
        dense_closest_hit.launches += 1
        _build.check(code, "dense_closest_hit")
    return Hit(out_t.reshape(shape), Vec3(*(c.reshape(shape) for c in out_n)),
               out_m.reshape(shape))


def dense_any_hit(bvh, ray, t_min, limit, skip=None) -> torch.Tensor:
    """True where some triangle lies at t in [t_min, limit) (``limit`` a
    number or a tensor that broadcasts against the lanes). Lanes in
    ``skip`` (bool, already known occluded) are not tested and read False,
    as do lanes with ``limit <= t_min``. CPU rays take
    `dense_any_hit_plain`; CUDA rays launch K-dense once, which stops a
    lane at its first triangle before ``limit``."""
    _check_tables("dense_any_hit", bvh)
    comps, shape = _lanes("dense_any_hit", bvh.leaves, ray)
    if comps[0].device.type == "cpu":
        return dense_any_hit_plain(bvh, ray, t_min, limit, skip)
    _on_card("dense_any_hit", comps)
    n, dev = comps[0].shape[0], comps[0].device
    limit = _lane_tensor("dense_any_hit", "limit", limit, DTYPE, shape, dev)
    if skip is not None:
        skip = _lane_tensor("dense_any_hit", "skip", skip, torch.bool, shape, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        p = _params(bvh, comps, t_min)
        p.limit, p.limit_stride, p.out_hit = limit.data_ptr(), limit.stride(0), out.data_ptr()
        if skip is not None:
            p.skip, p.skip_stride = skip.data_ptr(), skip.stride(0)
        code = _build.library().lib.rpt_dense_any_hit(ctypes.byref(p), _build.stream_of(out))
        dense_any_hit.launches += 1
        _build.check(code, "dense_any_hit")
    return out.reshape(shape)


dense_closest_hit.launches = 0
dense_any_hit.launches = 0
