"""Frozen copy of `chip_smoke.py::_traverse_bound`: K1's (the BVH closest-hit kernel's) bound on one wavefront.

The rays and their per-lane inputs, the BVH's node and leaf rows (each
read once) and the five results moved, against at least one box test
(~20 operations) a lane. Counting the whole BVH on every call makes this
an upper bound on the bytes a wavefront needs: a design that reads only
the rows its rays visit could one day come closer to it on small
wavefronts.
"""

from __future__ import annotations

import torch

from . import peaks

KERNEL = "traverse_kernel<false"  # K1's kernels in the trace (K2 is <true, ...>)
OPS_PER_LANE = 20


def bound_s(args, kwargs, outs) -> float:
    """The bound of one call of `rpt_tpu_torch.ops.bvh_traverse.bvh_closest_hit`."""
    bvh, lanes = args[0], args[1].shape[0]
    inputs = [a for a in (*args[1:], *kwargs.values()) if isinstance(a, torch.Tensor)]
    return peaks.bound_s(peaks.nbytes(*inputs, bvh.nodes, bvh.leaves, *outs), lanes * OPS_PER_LANE)
