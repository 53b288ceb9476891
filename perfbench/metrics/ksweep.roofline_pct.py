"""K-sweep's share of its roofline over the window: the sum of the bounds
of every call of the sphere sweep (`rooflines/ksweep.py`, from the call's
arguments, captured where the photon integrator calls it) over the sum of
the device times of K-sweep's kernels, in percent."""

from perfbench.rooflines import ksweep

TARGET = "rpt_tpu_torch.integrators.photon.sphere_sweep"
CAPTURE = {TARGET: ksweep.bound_s}


def read(rec):
    bounds = rec["captured"].get(TARGET, [])
    times = [e - s for name, s, e in rec["kernels"] if any(k in name for k in ksweep.KERNELS)]
    if not bounds or not times:
        return None
    return 100.0 * sum(bounds) / (sum(times) / 1e9)
