"""K-knn's share of its roofline over the window: the sum of the bounds
of every call of `knn_query` (`rooflines/knn.py`, from the call's
arguments and answers, captured where the photon integrator calls it:
the surface and the volume gathers) over the sum of the device times of
K-knn's query kernels, in percent."""

from perfbench.rooflines import knn

TARGET = "rpt_tpu_torch.integrators.photon.knn_query"
CAPTURE = {TARGET: knn.bound_s}


def read(rec):
    bounds = rec["captured"].get(TARGET, [])
    times = [e - s for name, s, e in rec["kernels"] if knn.KERNEL in name]
    if not bounds or not times:
        return None
    return 100.0 * sum(float(b) for b in bounds) / (sum(times) / 1e9)
