"""Arithmetic of the metrics: percentiles, and the union of intervals
(frozen copy of `tools/profile_torch_photon.py::_busy_ms`)."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile of all ``values`` (linear between order
    statistics, numpy's default)."""
    if len(values) == 0:
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total

