"""Flattened BVH build and pair-packed layout (numpy copy of
`rpt_tpu/accel/bvh.py`, plus the loader of the native SAH builder).

The JAX package's own notes follow.

Replaces the reference's recursive in-tree ``KdTree<Triangle>``
(`rpt/src/kdtree.rs:238-348`, traversal :154-226). Recursive,
branchy tree descent cannot map onto a vector machine; the TPU-native design
is:

* **Build** (host, vectorized numpy — no Python recursion): Morton-code
  sort of primitive centroids + Karras 2012 binary radix tree. Every step
  (range finding, splits, ropes, bounding boxes) is a fixed-bound
  vectorized pass, so an 871k-triangle dragon builds in seconds on one CPU
  core. A C++ builder drop-in (the port's copy, ``csrc/bvh_builder.cpp``)
  accelerates this further.
* **Layout**: SoA arrays — node AABBs, left-child index, leaf ranges, and a
  *rope* (miss link). Leaves cover contiguous runs of Morton-sorted
  primitives (max ``LEAF_SIZE``).
* **Traversal** (device): each ray holds a single node cursor. AABB hit →
  descend to left child; miss or leaf-done → follow the rope. No stack, no
  recursion; the whole wavefront advances in lock-step inside one
  ``lax.while_loop`` (see `rpt_tpu.intersect.bvh_closest_hit`).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from ..ops._build import CSRC_DIR, compile_and_load

LEAF_SIZE = 8  # must match rpt_tpu_torch.intersect.LEAF_TRIS
SENTINEL = np.int32(-1)


@dataclass
class FlatBVH:
    """Flattened rope BVH (numpy, converted to device arrays at scene compile).

    Node ``i`` is a leaf iff ``count[i] > 0``; then it covers primitives
    ``perm[first[i] : first[i]+count[i]]``. Otherwise ``left[i]`` is the left
    child and ``left[i]+?`` the right — we store ``right`` explicitly.
    ``rope[i]`` is the node to visit after skipping/finishing node i
    (-1 = traversal done). Root is node 0.
    """

    bb_min: np.ndarray  # (n_nodes, 3) f32
    bb_max: np.ndarray  # (n_nodes, 3) f32
    left: np.ndarray  # (n_nodes,) i32 (undefined for leaves)
    right: np.ndarray  # (n_nodes,) i32 (undefined for leaves)
    first: np.ndarray  # (n_nodes,) i32 (leaf: first prim slot)
    count: np.ndarray  # (n_nodes,) i32 (0 = internal)
    rope: np.ndarray  # (n_nodes,) i32
    perm: np.ndarray  # (n_prims,) i32  primitive permutation (sorted order)

    @property
    def n_nodes(self) -> int:
        return len(self.count)


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: (n,3) in [0,1]."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def expand(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (expand(q[:, 0]) << np.uint64(2)) | (expand(q[:, 1]) << np.uint64(1)) | expand(q[:, 2])


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build a BVH over primitive AABBs.

    Above ``2 * leaf_size`` primitives it takes the native C++ binned-SAH
    builder, the JAX package's own source, so both packages pack the same
    leaves; a failed g++ build raises. Smaller sets take the numpy LBVH
    (Karras 2012 radix tree), as in the JAX package.
    """
    if len(bb_min) > 2 * leaf_size:
        return build_bvh_sah(bb_min, bb_max, leaf_size)
    return build_lbvh(bb_min, bb_max, leaf_size)


def build_lbvh(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Vectorized-numpy LBVH (Karras 2012); no recursion, no native code."""
    bb_min = np.asarray(bb_min, np.float64).reshape(-1, 3)
    bb_max = np.asarray(bb_max, np.float64).reshape(-1, 3)
    n = len(bb_min)
    if n == 0:
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        return FlatBVH(z3, z3, zi, zi, zi, zi, zi, zi)

    centroid = 0.5 * (bb_min + bb_max)
    lo, hi = centroid.min(0), centroid.max(0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    keys = _morton3((centroid - lo) / span)
    # tie-break duplicates with the index so all keys are distinct
    order = np.argsort(keys, kind="stable").astype(np.int64)
    keys64 = (keys[order] << np.uint64(32)) | np.arange(n, dtype=np.uint64)

    s_min = bb_min[order]
    s_max = bb_max[order]

    if n <= leaf_size:
        return FlatBVH(
            s_min.min(0, keepdims=True).astype(np.float32),
            s_max.max(0, keepdims=True).astype(np.float32),
            np.zeros(1, np.int32),
            np.zeros(1, np.int32),
            np.zeros(1, np.int32),
            np.array([n], np.int32),
            np.array([-1], np.int32),
            order.astype(np.int32),
        )

    first, last = _karras_ranges(keys64)
    split = _find_splits(keys64, first, last)

    # children: left covers [first, split], right covers [split+1, last]
    # child is a Karras leaf (single prim) if its range is a single index.
    n_int = n - 1
    left_is_leaf = split == first
    right_is_leaf = (split + 1) == last
    # In the pre-collapse tree: internal nodes 0..n-2, leaves n-1..2n-2
    left = np.where(left_is_leaf, split + n_int, split).astype(np.int64)
    right = np.where(right_is_leaf, split + 1 + n_int, split + 1).astype(np.int64)

    # ranges for all 2n-1 pre-collapse nodes
    all_first = np.concatenate([first, np.arange(n, dtype=np.int64)])
    all_last = np.concatenate([last, np.arange(n, dtype=np.int64)])
    sizes = all_last - all_first + 1

    parent = np.full(2 * n - 1, -1, np.int64)
    parent[left] = np.arange(n_int)
    parent[right] = np.arange(n_int)

    # ---- collapse: a node becomes a cut-leaf if its range fits in
    # leaf_size and its parent's doesn't (root can't be cut here: n > leaf).
    fits = sizes <= leaf_size
    parent_fits = np.zeros(2 * n - 1, bool)
    has_parent = parent >= 0
    parent_fits[has_parent] = fits[parent[has_parent]]
    is_cut_leaf = fits & ~parent_fits
    keep_internal = ~fits  # any node too big for a leaf stays internal
    keep = keep_internal | is_cut_leaf

    new_id = np.cumsum(keep) - 1  # dense renumbering of kept nodes
    k = int(keep.sum())

    k_first = all_first[keep]
    k_last = all_last[keep]
    k_leaf = is_cut_leaf[keep]

    # remap children for kept internal nodes
    kept_internal_ids = np.nonzero(keep_internal[:n_int])[0]
    nl = new_id[left[kept_internal_ids]]
    nr = new_id[right[kept_internal_ids]]

    out_left = np.zeros(k, np.int32)
    out_right = np.zeros(k, np.int32)
    ki_new = new_id[kept_internal_ids]
    out_left[ki_new] = nl.astype(np.int32)
    out_right[ki_new] = nr.astype(np.int32)

    out_first = k_first.astype(np.int32)
    out_count = np.where(k_leaf, (k_last - k_first + 1), 0).astype(np.int32)

    # node AABBs: leaves directly union their <=leaf_size prims (masked
    # gathers); internals converge bottom-up from children in <=depth rounds.
    s_min32 = s_min.astype(np.float32)
    s_max32 = s_max.astype(np.float32)
    node_min = np.full((k, 3), np.inf, np.float32)
    node_max = np.full((k, 3), -np.inf, np.float32)
    leaf_ids = np.nonzero(k_leaf)[0]
    for slot in range(leaf_size):
        idx = k_first[leaf_ids] + slot
        ok = idx <= k_last[leaf_ids]
        ii = leaf_ids[ok]
        np.minimum.at(node_min, ii, s_min32[idx[ok]])
        np.maximum.at(node_max, ii, s_max32[idx[ok]])

    # bottom-up union for internal nodes (fixed-point in <= tree depth rounds)
    int_ids = np.nonzero(~k_leaf)[0]
    il0, ir0 = out_left[int_ids], out_right[int_ids]
    for round_ in range(128):
        new_min = np.minimum(node_min[il0], node_min[ir0])
        new_max = np.maximum(node_max[il0], node_max[ir0])
        if round_ % 8 == 7 and np.array_equal(new_min, node_min[int_ids]) and np.array_equal(
            new_max, node_max[int_ids]
        ):
            break
        node_min[int_ids] = new_min
        node_max[int_ids] = new_max

    # ---- ropes: rope(left child) = right sibling; rope(right child) =
    # rope(parent); rope(root) = -1. Converges top-down in <= depth rounds.
    rope = np.full(k, SENTINEL, np.int32)
    internal_mask = out_count == 0
    il = out_left[internal_mask]
    ir = out_right[internal_mask]
    ii = np.nonzero(internal_mask)[0].astype(np.int32)
    for _ in range(64):
        new_rope = rope.copy()
        new_rope[il] = ir
        new_rope[ir] = rope[ii]
        if np.array_equal(new_rope, rope):
            break
        rope = new_rope

    return FlatBVH(
        node_min.astype(np.float32),
        node_max.astype(np.float32),
        out_left,
        out_right,
        out_first,
        out_count,
        rope,
        order.astype(np.int32),
    )


def pack_bvh(bvh: FlatBVH, verts: np.ndarray, normals: np.ndarray, mats: np.ndarray):
    """Pack a FlatBVH + triangle soup into the pair-packed row layout of
    `rpt_tpu_torch.intersect.BVHTables` (NODE_ROW/LEAF_ROW/SHADE_ROW there).

    Each packed node row describes an *internal* node: both children's
    boxes + (ptr, meta) pairs, where meta>0 marks a leaf child with that
    triangle count, meta==0 an internal child, meta<0 an empty slot.

    ``verts``/``normals``: (T, 3, 3) in ORIGINAL order; ``bvh.perm`` is
    applied here. Integers are stored as exact small floats (< 2^24).
    Returns (nodes, leaves, shade) float32 arrays.
    """
    from ..intersect import LEAF_ROW, LEAF_TRIS, NODE_ROW, SHADE_ROW

    k = bvh.n_nodes
    v = np.asarray(verts, np.float64).reshape(-1, 3, 3)[bvh.perm]
    nm = np.asarray(normals, np.float64).reshape(-1, 3, 3)[bvh.perm]
    m = np.asarray(mats).reshape(-1)[bvh.perm]
    t = len(v)

    leaf_mask = bvh.count > 0
    leaf_ids = np.cumsum(leaf_mask) - 1  # dense leaf-row numbering
    n_leaves = int(leaf_mask.sum())

    # --- leaf rows (component-major blocks of LEAF_TRIS slots) ----------
    leaves = np.zeros((max(n_leaves, 1), LEAF_ROW), np.float32)
    leaves[:, 9 * LEAF_TRIS :] = -1.0  # id block: -1 padding
    lf = np.nonzero(leaf_mask)[0]
    for slot in range(LEAF_TRIS):
        rows = leaf_ids[lf]
        idx = bvh.first[lf] + slot
        ok = slot < bvh.count[lf]
        rs, ii = rows[ok], idx[ok]
        v1 = v[ii, 0]
        e1 = v[ii, 1] - v1
        e2 = v[ii, 2] - v1
        for c, vals in enumerate(
            (v1[:, 0], v1[:, 1], v1[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
             e2[:, 0], e2[:, 1], e2[:, 2])
        ):
            leaves[rs, LEAF_TRIS * c + slot] = vals
        leaves[rs, LEAF_TRIS * 9 + slot] = ii

    # --- pair-packed internal node rows --------------------------------
    internal_mask = ~leaf_mask
    internal_ids = np.cumsum(internal_mask) - 1
    ii_all = np.nonzero(internal_mask)[0]

    # node row layout: [Lmin(3) Rmin(3) | Lmax(3) Rmax(3) | Lptr Rptr Lmeta Rmeta]
    if len(ii_all) == 0:
        # whole tree is a single leaf: synthesize one internal row with an
        # empty right child (inverted box -> never hit)
        nodes = np.zeros((1, NODE_ROW), np.float32)
        nodes[0, 0:3] = bvh.bb_min[0] if k else 0.0
        nodes[0, 3:6] = 1e30  # right min
        nodes[0, 6:9] = bvh.bb_max[0] if k else 0.0
        nodes[0, 9:12] = -1e30  # right max (inverted -> never hit)
        nodes[0, 12] = 0  # left ptr = leaf row 0
        nodes[0, 13] = 0
        nodes[0, 14] = bvh.count[0] if k else -1  # left meta
        nodes[0, 15] = -1  # right empty
    else:
        nodes = np.zeros((len(ii_all), NODE_ROW), np.float32)
        for side, child in ((0, bvh.left[ii_all]), (1, bvh.right[ii_all])):
            is_leaf = leaf_mask[child]
            ptr = np.where(is_leaf, leaf_ids[child], internal_ids[child])
            meta = np.where(is_leaf, bvh.count[child], 0)
            nodes[:, 3 * side : 3 * side + 3] = bvh.bb_min[child]
            nodes[:, 6 + 3 * side : 9 + 3 * side] = bvh.bb_max[child]
            nodes[:, 12 + side] = ptr
            nodes[:, 14 + side] = meta

    shade = np.zeros((max(t, 1), SHADE_ROW), np.float32)
    if t:
        shade[:, 0:9] = nm.reshape(t, 9)
        shade[:, 9] = m
    return nodes, leaves, shade, _required_stack_depth(nodes)


def _required_stack_depth(nodes: np.ndarray) -> int:
    """Exact host-side bound on traversal stack occupancy: the deepest
    internal-node depth + 1 (one push max per internal node on a path).
    Degenerate meshes (coincident centroids -> Morton-tie index splits) can
    exceed any fixed constant, so the device stack is sized per tree.
    Rounded up to a multiple of 8 (>= 8) for layout friendliness."""
    lptr = nodes[:, 12].astype(np.int64)
    rptr = nodes[:, 13].astype(np.int64)
    lmeta = nodes[:, 14]
    rmeta = nodes[:, 15]
    cur = np.array([0], np.int64)
    max_depth = 0
    while cur.size:
        children = np.concatenate([lptr[cur][lmeta[cur] == 0], rptr[cur][rmeta[cur] == 0]])
        if children.size == 0:
            break
        max_depth += 1
        cur = children
    return max(8, -(-(max_depth + 1) // 8) * 8)


def _common_prefix(keys: np.ndarray, i: np.ndarray, j: np.ndarray, n: int) -> np.ndarray:
    """delta(i, j): length of the common bit prefix of keys i and j;
    -1 out of range."""
    valid = (j >= 0) & (j < n)
    jj = np.clip(j, 0, n - 1)
    x = keys[i] ^ keys[jj]
    # count leading zeros of 64-bit x
    clz = 64 - _bit_length(x)
    return np.where(valid, clz, -1)


def _bit_length(x: np.ndarray) -> np.ndarray:
    # float64 log2 estimate (may be off by one near powers of two for
    # 64-bit values), then an exact fix-up shift test.
    est = np.frexp(x.astype(np.float64))[1].astype(np.int64)  # ~bit_length
    est = np.clip(est, 0, 64)
    # exact check: bit_length(x) = b iff x >> (b-1) == 1 (for x > 0)
    for _ in range(2):
        too_big = (est > 0) & ((x >> np.uint64(1) * (est - 1).clip(0).astype(np.uint64)) == 0)
        est[too_big] -= 1
        shifted = x >> est.clip(0, 63).astype(np.uint64)
        est[(shifted > 0) & (est < 64)] += 1
    return est


def _karras_ranges(keys: np.ndarray):
    """Per internal node i in [0, n-2]: the primitive range it covers
    (Karras 2012, 'Maximizing Parallelism in the Construction of BVHs...')."""
    n = len(keys)
    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(
        _common_prefix(keys, i, i + 1, n) - _common_prefix(keys, i, i - 1, n)
    ).astype(np.int64)
    d[d == 0] = 1
    delta_min = _common_prefix(keys, i, i - d, n)

    # exponential search for the far end
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = i + lmax * d
        ok = _common_prefix(keys, i, probe, n) > delta_min
        if not ok.any():
            break
        lmax[ok] *= 2
        if (lmax > 2 * n).all():
            break

    # binary search within [0, lmax)
    length = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        tt = np.maximum(t, 1)
        probe = i + (length + tt) * d
        ok = (t >= 1) & (_common_prefix(keys, i, probe, n) > delta_min)
        length[ok] += tt[ok]
        t //= 2
    j = i + length * d
    return np.minimum(i, j), np.maximum(i, j)


def _find_splits(keys: np.ndarray, first: np.ndarray, last: np.ndarray) -> np.ndarray:
    """Split position: highest differing bit within [first, last]."""
    n = len(keys)
    delta_node = _common_prefix(keys, first, last, n)
    split = first.copy()
    stride = (last - first).astype(np.int64)
    # binary search: find the largest s in [first, last-1] with
    # delta(first, s+1...) > delta_node
    t = stride
    while True:
        t = (t + 1) // 2
        probe = split + t
        ok = (probe < last) & (_common_prefix(keys, first, probe, n) > delta_node)
        split[ok] = probe[ok]
        if (t <= 1).all():
            break
    return split


# ---------------------------------------------------------------------------
# Native binned-SAH builder. The C++ source is this package's own copy,
# `csrc/bvh_builder.cpp`, compiled with g++ into the package's build
# directory on first use; the library has a plain C interface loaded with
# ctypes.

BVH_SOURCE = os.path.join(CSRC_DIR, "bvh_builder.cpp")

_bvh_lib = None


def _load_bvh():
    global _bvh_lib
    if _bvh_lib is None:
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        signatures = {
            "bvh_build": ([fp, fp, ctypes.c_int32, ctypes.c_int32], ctypes.c_void_p),
            "bvh_num_nodes": ([ctypes.c_void_p], ctypes.c_int32),
            "bvh_export": ([ctypes.c_void_p, fp, fp, ip, ip, ip, ip, ip], None),
            "bvh_free": ([ctypes.c_void_p], None),
        }
        _bvh_lib = compile_and_load("bvh_builder", [BVH_SOURCE],
                                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"],
                                    signatures)[0]
    return _bvh_lib


def build_bvh_sah(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int):
    """Binned-SAH build via the C++ library (`rpt_tpu/native/__init__.py`
    `build_bvh_sah`). Returns a FlatBVH."""
    lib = _load_bvh()
    bb_min = np.ascontiguousarray(bb_min, np.float32).reshape(-1, 3)
    bb_max = np.ascontiguousarray(bb_max, np.float32).reshape(-1, 3)
    n = len(bb_min)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    handle = lib.bvh_build(bb_min.ctypes.data_as(fp), bb_max.ctypes.data_as(fp), n,
                           int(leaf_size))
    try:
        k = lib.bvh_num_nodes(handle)
        out_min = np.empty((k, 3), np.float32)
        out_max = np.empty((k, 3), np.float32)
        left = np.empty(k, np.int32)
        right = np.empty(k, np.int32)
        first = np.empty(k, np.int32)
        count = np.empty(k, np.int32)
        perm = np.empty(max(n, 1), np.int32)
        lib.bvh_export(handle, out_min.ctypes.data_as(fp), out_max.ctypes.data_as(fp),
                       left.ctypes.data_as(ip), right.ctypes.data_as(ip),
                       first.ctypes.data_as(ip), count.ctypes.data_as(ip),
                       perm.ctypes.data_as(ip))
    finally:
        lib.bvh_free(handle)
    rope = np.full(k, -1, np.int32)  # unused by the pair-packed layout
    return FlatBVH(out_min, out_max, left, right, first, count, rope, perm[:n])
