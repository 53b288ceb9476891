"""Device milliseconds a pass of intersection (program span): the device
time of every operation that starts inside an ``intersect.closest`` or
``intersect.occluded`` span, over the window's ``sample`` spans. It holds
K-prim, K1/K2, and `dense_tri_hit`'s torch chain, which has no kernel of
its own for `intersect.device_ms_per_pass` to find by name."""

from perfbench.harness import spans as sp


def read(rec):
    spans = sp.recorded()
    if not spans or not rec["ops"]:
        return None
    roots = sp.named(spans, "sample")
    queries = [s for s in spans if s.name in ("intersect.closest", "intersect.occluded")]
    if not roots or not queries:
        return None
    return sp.device_ns_starting_in(rec["ops"], queries) / len(roots) / 1e6
