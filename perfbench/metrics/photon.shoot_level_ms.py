"""Host milliseconds a level of the photon shoot (program span): the mean
duration of the ``photon.shoot_level`` spans of `_shoot_launch`."""

from perfbench.harness import spans as sp


def read(rec):
    spans = sp.recorded()
    levels = sp.named(spans, "photon.shoot_level") if spans else []
    if not levels:
        return None
    return sum(s.end_ns - s.start_ns for s in levels) / len(levels) / 1e6
