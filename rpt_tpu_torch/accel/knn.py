"""Photon k-nearest-neighbour queries: a uniform grid built on the device
and the exact k-NN over it.

Replaces the JAX package's `rpt_tpu/accel/grid.py` (`build_photon_grid`
:237 and `knn_query` :605) with the same result contract: for each query
``(idx, d2, valid)`` of shape ``(n, k)``, ``idx`` indexing the
grid-sorted point arrays, ``d2`` ascending, ``valid = isfinite(d2)``.
The JAX grid truncates <0.5% of queries (`grid.py:1-25`); this one is
exact.

* `build_grid`: cell size from the cloud's bounding box (about one point
  per two cells over the box), points binned with f32 arithmetic, sorted
  by cell id (``torch.sort``), cell runs found with ``torch.searchsorted``.
* `knn_query` is the wrapper: for tensors on the CPU it runs `knn_plain`,
  chunked brute force (the exact spec); for CUDA tensors it launches the
  hand-written kernel `csrc/knn.cu` (K-knn) or raises.
  ``knn_query.launches`` counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import _build

MAX_CELLS = 1 << 24  # bounds the (cells + 1) int32 run table at 64 MiB
MAX_DIM = 1024
MAX_K = 128  # compile-time bound of the kernel's top-k list


@dataclass(frozen=True)
class PhotonGrid:
    """A point cloud sorted by uniform-grid cell.

    ``points``: (P, 3) f32 in cell order; ``order``: (P,) int64 with
    ``points = original[order]``; ``starts``: (cells + 1,) int32 cell runs.
    """

    points: torch.Tensor
    order: torch.Tensor
    starts: torch.Tensor
    origin: tuple
    h: float
    dims: tuple

    @property
    def n(self) -> int:
        return int(self.points.shape[0])


def _cell_ids(points: torch.Tensor, origin, inv_h: float, dims) -> torch.Tensor:
    """Linear cell id per point, f32 binning as the kernel's (x-major)."""
    o = torch.tensor(origin, dtype=torch.float32, device=points.device)
    c = torch.floor((points - o) * inv_h).to(torch.int64)
    d = torch.tensor(dims, dtype=torch.int64, device=points.device)
    c = torch.minimum(torch.clamp(c, min=0), d - 1)
    return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]


def build_grid(points: torch.Tensor) -> PhotonGrid:
    """Sort ``points`` (P, 3) f32 into a uniform grid on their device."""
    if points.dim() != 2 or points.shape[1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"build_grid: points must be float32 (P, 3), got {points.dtype} "
                         f"{tuple(points.shape)}")
    n = points.shape[0]
    dev = points.device
    if n == 0:
        return PhotonGrid(points, torch.zeros(0, dtype=torch.int64, device=dev),
                          torch.zeros(2, dtype=torch.int32, device=dev),
                          (0.0, 0.0, 0.0), 1.0, (1, 1, 1))
    lo = points.min(0).values.tolist()
    hi = points.max(0).values.tolist()
    span = [max(b - a, 1e-6) for a, b in zip(lo, hi)]
    # ~2 cells per point over the bounding box, at most MAX_CELLS cells
    # and MAX_DIM cells per axis
    target = min(2 * n, MAX_CELLS)
    h = (span[0] * span[1] * span[2] / target) ** (1.0 / 3.0)
    h = max(h, max(span) / MAX_DIM)
    while True:
        dims = tuple(min(MAX_DIM, max(1, int(s / h) + 1)) for s in span)
        if dims[0] * dims[1] * dims[2] <= MAX_CELLS:
            break
        h *= 1.25
    cid = _cell_ids(points, lo, 1.0 / h, dims)
    sorted_cid, order = torch.sort(cid, stable=True)
    cells = torch.arange(dims[0] * dims[1] * dims[2] + 1, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_cid, cells).to(torch.int32)
    return PhotonGrid(points[order].contiguous(), order, starts, tuple(lo), h, dims)


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


def knn_query(grid: PhotonGrid, queries: torch.Tensor, k: int):
    """k nearest grid points per query (n, 3) f32: ``(idx, d2, valid)``,
    each (n, k), ``idx`` into ``grid.points``. CPU tensors take
    `knn_plain`; CUDA tensors launch K-knn."""
    if queries.dim() != 2 or queries.shape[1] != 3 or queries.dtype != torch.float32:
        raise ValueError(f"knn_query: queries must be float32 (n, 3), got {queries.dtype} "
                         f"{tuple(queries.shape)}")
    if queries.device != grid.points.device:
        raise ValueError(f"knn_query: queries on {queries.device}, grid on {grid.points.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_query: k={k} outside [1, {MAX_K}]")
    if queries.device.type == "cpu":
        return knn_plain(grid.points, queries, k)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_query: unsupported device {queries.device}")
    n = queries.shape[0]
    dev = queries.device
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0 or grid.n == 0:
        idx.zero_()
        d2.fill_(float("inf"))
        return idx.long(), d2, torch.zeros((n, k), dtype=torch.bool, device=dev)
    queries = queries.contiguous()
    nx, ny, nz = grid.dims
    ox, oy, oz = grid.origin
    lib = _build.library().lib
    code = lib.rpt_knn_grid(
        queries.data_ptr(), n, grid.points.data_ptr(), grid.starts.data_ptr(),
        nx, ny, nz, ox, oy, oz, grid.h, 1.0 / grid.h, k, idx.data_ptr(), d2.data_ptr(),
        _build.stream_of(queries),
    )
    knn_query.launches += 1
    _build.check(code, "knn_query")
    valid = torch.isfinite(d2)
    return torch.where(valid, idx.long(), 0), d2, valid


knn_query.launches = 0
