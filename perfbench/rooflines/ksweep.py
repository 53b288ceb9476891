"""Frozen copy of `chip_smoke.py`'s K-sweep bound (`_sweep_case`'s bytes): one sweep's bound.

The rays, their hit times, the kernel-side sphere table (records and tile
bounds, each read once) and the estimates written, at the card's memory
rate. `chip_smoke.py` also counts 30 operations a pierced (ray, sphere)
pair; the pierced pairs are not counted here, so this is the bytes term
alone: a lower bound, no larger than the full one (on the lampshade's
wavefronts the bytes were the larger term).
"""

from __future__ import annotations

from . import peaks

KERNELS = ("cull_tiles", "compact_tiles", "scan_counts", "sweep_tiles", "sum_slots")


def bound_s(args, kwargs, out) -> float:
    """The bound of one call of `rpt_tpu_torch.ops.sphere_sweep.sphere_sweep`
    (rays, directions, hit times, the `SphereTable`, ...)."""
    ray_o, ray_d, hit_time, table = args[:4]
    return peaks.bound_s(peaks.nbytes(ray_o, ray_d, hit_time, table.records, table.bounds, out), 0)
