"""Photon k-nearest-neighbour queries: a grid with levels built on the
device and the exact k-NN over it.

Replaces the JAX package's `rpt_tpu/accel/grid.py` (`build_photon_grid`
:237 and `knn_query` :605) with the same result contract: for each query
``(idx, d2, valid)`` of shape ``(n, k)``, ``idx`` indexing the
grid-sorted point arrays, ``d2`` ascending, ``valid = isfinite(d2)``.
The JAX grid truncates <0.5% of queries (`grid.py:1-25`); this one is
exact.

* `build_grid`: a cube of ``2^LEVELS`` finest cells an axis over the
  cloud; points binned with f32 arithmetic and sorted by the 48-bit Morton
  code of their finest cell (``torch.sort``). A cell of level ``l`` is the
  Morton prefix ``code >> 3l`` and its points one run of the sorted array,
  found by two binary searches of the codes: there is no table per level,
  so the cells are as fine where the cloud is dense as they are coarse
  where it is thin (a photon cloud is a dense body in a halo a hundred
  times wider).
* `knn_query` is the wrapper: for tensors on the CPU it runs `knn_plain`,
  chunked brute force (the exact spec); for CUDA tensors it launches the
  hand-written kernel `csrc/knn.cu` (K-knn) or raises.
* `knn_radius` is the self-query of the radius pass: per grid point the
  k-th nearest distance^2, itself included, in one launch, for k in
  `REGISTER_K`; on the CPU `knn_radius_plain`.
* `knn_levels_plain` and `radius_units_plain` are the kernels' walk and
  unit cut in torch ops, for the tests; `knn_query_counts` and
  `knn_radius_counts` launch the kernels' counting variants (levels, cells
  and candidates per query) for the smoke run and the profile tool.

`ops._build.launch` counts every launch under its wrapper's name.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

from ..ops import _build

LEVELS = 16  # 2^16 finest cells an axis, 48-bit Morton codes (csrc/knn.cu kBits)
MAX_K = 128  # compile-time bound of the kernel's top-k list (csrc/knn.cu kMaxK)
REGISTER_K = (10, 20)  # the self-query's k (csrc/knn.cu `rpt_knn_radius`), a lane's list in registers
UNIT = 32  # most points of a self-query unit: one a lane of a warp (csrc/knn.cu kUnit)


def want_points(k: int) -> int:
    """A query starts at the finest level whose own cell holds this many
    points: a ball of the cell's width then holds about k (4.19 cells of a
    filled volume, 3.14 of a surface)."""
    return (k + 3) // 4


@dataclass(frozen=True)
class PhotonGrid:
    """A point cloud sorted by the Morton code of its finest grid cell.

    ``points``: (P, 3) f32 in code order; ``rows``: (P, 4) f32, the points
    padded to the kernels' 16-byte rows; ``codes``: (P,) int64 ascending,
    the Morton code of each point's finest cell; ``order``: (P,) int64 with
    ``points = original[order]``. The finest cells have width ``h``,
    ``2^LEVELS`` an axis from ``origin``; ``slack`` bounds the f32 rounding
    of a cell face against a point.
    """

    points: torch.Tensor
    rows: torch.Tensor
    codes: torch.Tensor
    order: torch.Tensor
    origin: tuple
    h: float
    slack: float

    @property
    def n(self) -> int:
        return int(self.points.shape[0])


def _spread(v: torch.Tensor) -> torch.Tensor:
    """16-bit integers (int64) with two zero bits inserted after every bit."""
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    return (v | (v << 2)) & 0x1249249249249249


def morton_code(cells: torch.Tensor) -> torch.Tensor:
    """Morton code of (..., 3) int64 cell coordinates (x the highest bit)."""
    return (_spread(cells[..., 0]) << 2) | (_spread(cells[..., 1]) << 1) | _spread(cells[..., 2])


def cell_coords(points: torch.Tensor, origin, h: float) -> torch.Tensor:
    """Finest cell coordinates per point, (n, 3) int64, clamped into the
    grid: f32 binning as the kernel's."""
    o = torch.tensor(origin, dtype=torch.float32, device=points.device)
    return torch.clamp(torch.floor((points - o) * (1.0 / h)).to(torch.int64), 0,
                       (1 << LEVELS) - 1)


def cell_runs(grid: PhotonGrid, prefix: torch.Tensor, level: int):
    """``(first row, length)`` of the level-``level`` cells whose Morton
    prefixes are ``prefix`` (int64, any shape)."""
    a = torch.searchsorted(grid.codes, (prefix << (3 * level)).reshape(-1))
    e = torch.searchsorted(grid.codes, ((prefix + 1) << (3 * level)).reshape(-1))
    return a.reshape(prefix.shape), (e - a).reshape(prefix.shape)


def build_grid(points: torch.Tensor) -> PhotonGrid:
    """Sort ``points`` (P, 3) f32 by the Morton code of their finest cell,
    on their device."""
    if points.dim() != 2 or points.shape[1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"build_grid: points must be float32 (P, 3), got {points.dtype} "
                         f"{tuple(points.shape)}")
    n = points.shape[0]
    dev = points.device
    if n == 0:
        return PhotonGrid(points, torch.zeros((0, 4), dtype=torch.float32, device=dev),
                          torch.zeros(0, dtype=torch.int64, device=dev),
                          torch.zeros(0, dtype=torch.int64, device=dev), (0.0, 0.0, 0.0), 1.0, 0.0)
    lo = points.min(0).values.tolist()
    hi = points.max(0).values.tolist()
    side = max(max(b - a for a, b in zip(lo, hi)), 1e-6)
    # a face o + c * h and a point's cell floor((p - o) / h) each round at
    # the scale of the coordinates (2^-24 relative): 4e-6 of it bounds both
    slack = 4e-6 * max(side, max(abs(v) for v in lo + hi))
    h = side / (1 << LEVELS)
    codes, order = torch.sort(morton_code(cell_coords(points, lo, h)), stable=True)
    rows = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rows[:, 0:3] = points[order]
    return PhotonGrid(rows[:, 0:3].contiguous(), rows, codes, order, tuple(lo), h, slack)


def knn_plain(points: torch.Tensor, queries: torch.Tensor, k: int):
    """Exact k-NN by chunked brute force: ``(idx, d2, valid)`` (n, k),
    ``d2`` ascending. Distances use the kernel's operation order."""
    n = queries.shape[0]
    p = points.shape[0]
    dev = queries.device
    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    d2 = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    kk = min(k, p)
    if kk and n:
        chunk = max(1, (1 << 26) // p)
        px, py, pz = points[:, 0][None, :], points[:, 1][None, :], points[:, 2][None, :]
        for s in range(0, n, chunk):
            q = queries[s : s + chunk]
            dx = px - q[:, 0:1]
            dy = py - q[:, 1:2]
            dz = pz - q[:, 2:3]
            dist = dx * dx + dy * dy + dz * dz
            vals, ids = torch.topk(dist, kk, dim=1, largest=False, sorted=True)
            d2[s : s + chunk, :kk] = vals
            idx[s : s + chunk, :kk] = ids
    valid = torch.isfinite(d2)
    return torch.where(valid, idx, 0), d2, valid


def knn_radius_plain(grid: PhotonGrid, k: int) -> torch.Tensor:
    """Per grid point the k-th nearest distance^2, itself included; of a
    cloud of fewer than k points the largest: `knn_plain`'s last valid
    column."""
    _, d2, valid = knn_plain(grid.points, grid.points, k)
    return torch.where(valid, d2, 0.0).max(dim=1).values


def _gap2(q, lo, hi, slack):
    """The kernel's `gap2`: squared distance from q to the slab [lo, hi]
    with its faces pushed out by ``slack``."""
    return torch.clamp(torch.maximum(lo - slack - q, q - hi - slack), min=0.0) ** 2


def _covered2(grid: PhotonGrid, q, c, level: int):
    """The kernel's `covered2` for queries ``q`` (m, 3) whose cells at
    ``level`` are ``c`` (m, 3): the squared distance to the nearest cell
    outside the 3x3x3 block, infinite when the block is the whole grid."""
    dim = 1 << (LEVELS - level)
    hl = grid.h * (1 << level)
    slack = grid.slack
    o = torch.tensor(grid.origin, dtype=torch.float32, device=q.device)
    out = _gap2(q, o, o + grid.h * (1 << LEVELS), slack)  # to the grid's extent, per axis
    lo, hi = torch.clamp(c - 1, min=0), torch.clamp(c + 1, max=dim - 1)
    cover = torch.full((q.shape[0],), float("inf"), dtype=torch.float32, device=q.device)
    for a in range(3):
        others = out.sum(dim=1) - out[:, a]
        below = torch.clamp(q[:, a] - (o[a] + lo[:, a] * hl) - slack, min=0.0) ** 2 + others
        above = torch.clamp(o[a] + (hi[:, a] + 1) * hl - q[:, a] - slack, min=0.0) ** 2 + others
        cover = torch.where(lo[:, a] > 0, torch.minimum(cover, below), cover)
        cover = torch.where(hi[:, a] < dim - 1, torch.minimum(cover, above), cover)
    return cover


def knn_levels_plain(grid: PhotonGrid, queries: torch.Tensor, k: int):
    """K-knn's walk in torch ops: each query starts at the finest level
    whose own cell holds `want_points` points, takes the k nearest of the
    3x3x3 cells around it, and accepts them once the k-th distance^2 is
    within the covered radius^2, else starts over one level coarser.
    Returns ``(idx, d2, valid, level)``, ``level`` the one that certified.
    Every candidate list is padded to the longest: for small clouds."""
    n, dev = queries.shape[0], queries.device
    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    d2 = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    level = torch.full((n,), LEVELS, dtype=torch.int64, device=dev)
    if n == 0 or grid.n == 0:
        return idx, d2, torch.isfinite(d2), level
    c0 = cell_coords(queries, grid.origin, grid.h)
    code0 = morton_code(c0)
    for l in range(LEVELS, -1, -1):  # the finest level whose own cell holds enough
        level = torch.where(cell_runs(grid, code0 >> (3 * l), l)[1] >= want_points(k), l, level)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    offsets = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)), device=dev)
    for l in range(LEVELS + 1):
        act = torch.nonzero(~done & (level <= l))[:, 0]
        if act.numel() == 0:
            continue
        q, c, dim = queries[act], c0[act] >> l, 1 << (LEVELS - l)
        nb = c[:, None, :] + offsets[None, :, :]  # (m, 27, 3)
        inside = ((nb >= 0) & (nb < dim)).all(dim=2)
        run_a, run_n = cell_runs(grid, morton_code(torch.clamp(nb, 0, dim - 1)), l)
        run_n = torch.where(inside, run_n, 0)
        pre = torch.cumsum(run_n, dim=1)
        total = pre[:, -1]
        t = torch.arange(max(int(total.max()), 1), device=dev)[None, :].expand(act.numel(), -1)
        r = torch.clamp(torch.searchsorted(pre, t.contiguous(), right=True), max=26)
        live = t < total[:, None]
        src = torch.where(live, torch.gather(run_a, 1, r) + t - torch.gather(pre - run_n, 1, r), 0)
        p = grid.points[src]
        dx, dy, dz = (p[..., a] - q[:, a : a + 1] for a in range(3))
        dist = torch.where(live, dx * dx + dy * dy + dz * dz, float("inf"))
        kk = min(k, dist.shape[1])
        vals, pos = torch.topk(dist, kk, dim=1, largest=False, sorted=True)
        kth = vals[:, k - 1] if kk == k else torch.full_like(vals[:, 0], float("inf"))
        cover2 = _covered2(grid, q, c, l)
        ok = torch.isinf(cover2) | (kth <= cover2)
        rows = act[ok]
        d2[rows, :kk] = vals[ok]
        idx[rows, :kk] = torch.gather(src, 1, pos)[ok]
        level[rows] = l
        done[rows] = True
    valid = torch.isfinite(d2)
    return torch.where(valid, idx, 0), d2, valid, level


def radius_units_plain(grid: PhotonGrid, unit: int = UNIT):
    """The self-query kernel's unit cut in torch ops: per grid point the
    ``(start, count, level)`` of its unit, the coarsest cell around it
    that holds at most ``unit`` points (a finest cell with more is cut
    into runs of ``unit``)."""
    lane = torch.arange(grid.n, device=grid.codes.device)
    a, count = cell_runs(grid, grid.codes, 0)
    crowded = count > unit
    start = torch.where(crowded, lane - (lane - a) % unit, a)
    count = torch.where(crowded, torch.clamp(a + count - start, max=unit), count)
    level = torch.zeros_like(lane)
    for l in range(1, LEVELS + 1):
        a2, n2 = cell_runs(grid, grid.codes >> (3 * l), l)
        grow = ~crowded & (level == l - 1) & (n2 <= unit)
        start, count = torch.where(grow, a2, start), torch.where(grow, n2, count)
        level = level + grow.long()
    return start, count, level


def _check_queries(name: str, grid: PhotonGrid, queries: torch.Tensor, k: int) -> None:
    if queries.dim() != 2 or queries.shape[1] != 3 or queries.dtype != torch.float32:
        raise ValueError(f"{name}: queries must be float32 (n, 3), got {queries.dtype} "
                         f"{tuple(queries.shape)}")
    if queries.device != grid.points.device:
        raise ValueError(f"{name}: queries on {queries.device}, grid on {grid.points.device}")
    _check_k(name, grid, k)


def _check_k(name: str, grid: PhotonGrid, k: int, allowed=None) -> None:
    if allowed is not None and k not in allowed:
        raise ValueError(f"{name}: k={k}, the self-query kernel exists for k in {allowed}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside [1, {MAX_K}]")
    if grid.points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {grid.points.device}")


def _grid_args(grid: PhotonGrid) -> tuple:
    return (grid.rows.data_ptr(), grid.codes.data_ptr(), grid.n, *grid.origin, grid.h,
            1.0 / grid.h, grid.slack)


def _launch_query(name: str, grid: PhotonGrid, queries: torch.Tensor, k: int, counts):
    n, dev = queries.shape[0], queries.device
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    queries = queries.contiguous()
    _build.launch(name, "rpt_knn_query", queries, *_grid_args(grid), queries.data_ptr(), n, k,
                  want_points(k), idx.data_ptr(), d2.data_ptr(),
                  None if counts is None else counts.data_ptr())
    return idx, d2


def _launch_radius(name: str, grid: PhotonGrid, k: int, counts):
    out = torch.empty(grid.n, dtype=torch.float32, device=grid.points.device)
    _build.launch(name, "rpt_knn_radius", out, *_grid_args(grid), k, want_points(k),
                  out.data_ptr(), None if counts is None else counts.data_ptr())
    return out


def knn_query(grid: PhotonGrid, queries: torch.Tensor, k: int):
    """k nearest grid points per query (n, 3) f32: ``(idx, d2, valid)``,
    each (n, k), ``idx`` into ``grid.points``. CPU tensors take
    `knn_plain`; CUDA tensors launch K-knn."""
    _check_queries("knn_query", grid, queries, k)
    if queries.device.type == "cpu":
        return knn_plain(grid.points, queries, k)
    n, dev = queries.shape[0], queries.device
    if n == 0 or grid.n == 0:
        d2 = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
        return torch.zeros((n, k), dtype=torch.int64, device=dev), d2, torch.isfinite(d2)
    idx, d2 = _launch_query("knn_query", grid, queries, k, None)
    valid = torch.isfinite(d2)
    return torch.where(valid, idx.long(), 0), d2, valid


def knn_radius(grid: PhotonGrid, k: int) -> torch.Tensor:
    """Per grid point (grid order) the k-th nearest distance^2, itself
    included; of a cloud of fewer than k points the largest. (P,) f32; k
    in `REGISTER_K`. A grid on the CPU takes `knn_radius_plain`; one on
    the card launches K-knn's self-query kernel, once."""
    _check_k("knn_radius", grid, k, REGISTER_K)
    if grid.points.device.type == "cpu":
        return knn_radius_plain(grid, k)
    if grid.n == 0:
        return torch.empty(0, dtype=torch.float32, device=grid.points.device)
    return _launch_radius("knn_radius", grid, k, None)


def knn_query_counts(grid: PhotonGrid, queries: torch.Tensor, k: int) -> torch.Tensor:
    """The counting variant of `knn_query`'s kernel (any k in [1,
    `MAX_K`], on the card): per query ``(levels scanned, cells looked up,
    candidates tested, start level)``, (n, 4) int32."""
    _check_queries("knn_query_counts", grid, queries, k)
    counts = torch.zeros((queries.shape[0], 4), dtype=torch.int32, device=queries.device)
    if queries.shape[0] and grid.n:
        _launch_query("knn_query_counts", grid, queries, k, counts)
    return counts


def knn_radius_counts(grid: PhotonGrid, k: int) -> torch.Tensor:
    """The counting variant of `knn_radius`'s kernel (k in `REGISTER_K`,
    on the card): per grid point ``(levels scanned, cells looked up,
    candidates tested, points of its unit)``, (P, 4) int32; more than one
    level means its unit's certificate failed and it went on a level up."""
    _check_k("knn_radius_counts", grid, k, REGISTER_K)
    counts = torch.zeros((grid.n, 4), dtype=torch.int32, device=grid.points.device)
    if grid.n:
        _launch_radius("knn_radius_counts", grid, k, counts)
    return counts
