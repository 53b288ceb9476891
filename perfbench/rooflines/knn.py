"""Frozen copy of `chip_smoke.py::_gather_bound`: K-knn's (the k-nearest query kernel's) bound on one gather.

Bytes: the distinct grid points among the call's answers read once
(16-byte rows), the queries read once (12 bytes each), and an int32
index and a float32 squared distance written for each of a query's k
neighbours (the valid flags are the distances' finiteness, taken after
the kernel, and cost it no bytes). The rest of the cloud, and the few
Morton codes of the cell table that the kernel's binary searches read,
are left out, so this is a lower bound. Operations: at least 8 for each
of a query's k distances.

`_gather_bound` counts the distinct points with `torch.unique`, which
waits for the card; here they are counted on the card, by marking each
answered point in a table of the grid's size, and the count stays there
until the window is read, so capturing a call adds three small device
operations and no wait.
"""

from __future__ import annotations

import torch

from . import peaks

KERNEL = "knn_query_kernel"  # K-knn's query kernels in the trace (not knn_radius_kernel)
ROW_BYTES = 16  # a photon row of the grid: x, y, z and a pad
ANSWER_BYTES = 8  # an int32 index and a float32 squared distance
OPS_PER_DISTANCE = 8


def distinct_rows(grid_n: int, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The number of distinct points among the valid answers, as a 0-d
    tensor on their device."""
    marks = torch.zeros(grid_n + 1, dtype=torch.bool, device=idx.device)
    marks[torch.where(valid, idx, grid_n)] = True  # invalid answers mark the spare entry
    return marks[:grid_n].sum()


def bound_s(args, kwargs, outs):
    """The bound of one call of `rpt_tpu_torch.accel.knn.knn_query` (grid,
    queries, k) returning ``(idx, d2, valid)``: a 0-d tensor of seconds on
    the call's device; 0.0 for a call that launches nothing (no query or an
    empty grid)."""
    params = dict(zip(("grid", "queries", "k"), args), **kwargs)
    grid, queries, k = params["grid"], params["queries"], int(params["k"])
    n = queries.shape[0]
    if n == 0 or grid.n == 0:
        return 0.0
    idx, _, valid = outs
    n_bytes = (distinct_rows(grid.n, idx, valid).double() * ROW_BYTES
               + peaks.nbytes(queries) + n * k * ANSWER_BYTES)
    return torch.clamp(n_bytes / peaks.MEM_BYTES_PER_S,
                       min=n * k * OPS_PER_DISTANCE / peaks.FP32_OPS_PER_S)
