"""Frozen copy of `chip_smoke.py`'s peaks (`MEM_BYTES_PER_S`, `FP32_OPS_PER_S`, `_bound`, `_nbytes`).

The card's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
limit): HBM bytes a second, and float32 operations a second outside the
tensor cores (128 lanes a multiprocessor, a fused multiply-add counted as
two, 132 multiprocessors at 1.98 GHz).
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time: the larger of moving ``n_bytes`` at the HBM rate and
    doing ``n_ops`` float32 operations at the peak rate."""
    return max(n_bytes / MEM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)
