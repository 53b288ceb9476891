"""Host milliseconds of the point-query estimate a camera wavefront
(program span): the mean over the window's ``photon.estimate`` spans of
their duration less that of their ``intersect.closest`` children. In a
photon-map scene with a medium that is `volume_estimate_point`: the free
flight, the volume gather and its density, the surface estimate with its
gather and recheck."""

from perfbench.harness import spans as sp


def read(rec):
    spans = sp.recorded()
    estimates = sp.named(spans, "photon.estimate") if spans else []
    if not estimates:
        return None
    return sum(sp.self_ns(e, spans, "intersect.closest") for e in estimates) / len(estimates) / 1e6
