"""The share of the card's idle time that falls inside the point-query
estimate (program span): 100 x the idle time inside ``photon.estimate``
spans less that inside their ``intersect.closest`` children / all the
card's idle time in the window (the first render's start to the last
render's end; idle = the complement of the union of the device
operations' intervals): how much of a render's idle time the point-query
camera pass holds, where `idle.in_shoot_pct` reads the shoot's."""

from perfbench.harness import spans as sp


def read(rec):
    spans, win = sp.recorded(), sp.window(rec)
    if spans is None or win is None or not rec["ops"]:
        return None
    estimates = sp.named(spans, "photon.estimate")
    ids = {e.id for e in estimates}
    closest = [s for s in spans if s.name == "intersect.closest" and s.parent in ids]
    gaps = sp.idle(rec["ops"], *win)
    total = sum(e - s for s, e in gaps)
    if not estimates or total <= 0:
        return None
    inside = sp.overlap_ns(gaps, sp.intervals(estimates))
    return 100.0 * (inside - sp.overlap_ns(gaps, sp.intervals(closest))) / total
