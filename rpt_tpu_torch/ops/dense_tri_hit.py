"""Closest hit and any hit against a small triangle mesh (K-dense).

The JAX package tests a mesh of at most ``DENSE_TRI_ROWS`` packed leaf rows
densely, every row against every ray of the wavefront with no traversal,
in one XLA program (`rpt_tpu/intersect.py:652` ``dense_tri_hit``,
`_leaf_rows_test` `:376`, `_finish_hit` `:674`). The port's plain version
is `dense_tri_hit_plain` below: a chain of torch ops a leaf row
(`leaf_rows_test`, which the traversal's plain version also runs on its
leaves), then the shading gather (`finish_hit`, which also shades K1's
hits). The kernel is `csrc/dense_tri_hit.cu`, one thread a ray over every
triangle, the rows in shared memory.

`dense_closest_hit` and `dense_any_hit` are the wrappers: for rays on the
CPU they run the plain version; for CUDA tensors they launch the kernel,
once a call (`_build.launch`), or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..accel.bvh import LEAF_ROW, LEAF_TRIS, SHADE_ROW, BVHTables
from ..dtypes import DTYPE, EPS, INF
from ..ray import Hit, Ray
from ..vec import Vec3, where

DENSE_TRI_ROWS = 8  # meshes of at most 8 leaf rows (64 tris), the kernel's shared rows (kMaxRows)


def _check_tables(name: str, bvh) -> None:
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
# The plain version: a chain of torch ops a leaf row


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


def leaf_rows_test(leaf, count, ray: Ray, t_min, time, tri, bu, bv, bw):
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
    plain version of K-dense."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    time = best.time
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    z = torch.zeros(n, dtype=DTYPE, device=dev)
    bu = bv = bw = z
    for row_i in range(bvh.leaves.shape[0]):
        time, tri, bu, bv, bw = leaf_rows_test(
            bvh.leaves[row_i : row_i + 1], LEAF_TRIS, ray, t_min, time, tri, bu, bv, bw
        )
    return finish_hit(bvh, best, time, tri, bu, bv, bw)


def finish_hit(bvh: BVHTables, best: Hit, time, tri, u, v, w) -> Hit:
    """Merge a triangle query's ``(time, tri, u, v, w)`` into ``best``:
    where the mesh is nearer, its time, the normal interpolated from the
    winner's shade row and its material (`rpt_tpu/intersect.py:674`)."""
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


def dense_any_hit_plain(bvh, ray, t_min, limit, skip=None) -> torch.Tensor:
    """True where some triangle lies at t in [t_min, limit): the chain's
    closest time from no hit, against ``limit``; lanes in ``skip`` read
    False."""
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
    _check_tables("dense_closest_hit", bvh)
    comps, shape = _build.lanes("dense_closest_hit", bvh.leaves, ray)
    if comps[0].device.type == "cpu":
        return dense_tri_hit_plain(bvh, ray, t_min, best)
    n, dev = comps[0].shape[0], comps[0].device
    ins = [_build.lane_tensor("dense_closest_hit", "best", x, dtype, shape, dev)
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
        _build.launch("dense_closest_hit", "rpt_dense_closest_hit", out_t, ctypes.byref(p))
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
    comps, shape = _build.lanes("dense_any_hit", bvh.leaves, ray)
    if comps[0].device.type == "cpu":
        return dense_any_hit_plain(bvh, ray, t_min, limit, skip)
    n, dev = comps[0].shape[0], comps[0].device
    limit = _build.lane_tensor("dense_any_hit", "limit", limit, DTYPE, shape, dev)
    if skip is not None:
        skip = _build.lane_tensor("dense_any_hit", "skip", skip, torch.bool, shape, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        p = _params(bvh, comps, t_min)
        p.limit, p.limit_stride, p.out_hit = limit.data_ptr(), limit.stride(0), out.data_ptr()
        if skip is not None:
            p.skip, p.skip_stride = skip.data_ptr(), skip.stride(0)
        _build.launch("dense_any_hit", "rpt_dense_any_hit", out, ctypes.byref(p))
    return out.reshape(shape)

