"""K1's share of its roofline over the window: the sum of the bounds of
every call of `ops.bvh_traverse.bvh_closest_hit` (`rooflines/k1.py`, from
the call's arguments) over the sum of K1's kernel times, in percent."""

from perfbench.rooflines import k1

CAPTURE = {"rpt_tpu_torch.ops.bvh_traverse.bvh_closest_hit": k1.bound_s}


def read(rec):
    bounds = rec["captured"].get("rpt_tpu_torch.ops.bvh_traverse.bvh_closest_hit", [])
    times = [e - s for name, s, e in rec["kernels"] if k1.KERNEL in name]
    if not bounds or not times or len(bounds) != len(times):
        return None
    return 100.0 * sum(bounds) / (sum(times) / 1e9)
