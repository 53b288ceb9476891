"""Host milliseconds a level of the path tracer (program span): the mean
duration of the ``path.level`` spans of `trace_volumetric` and
`trace_surface`, a level's launches from its first to its compaction."""

from perfbench.harness import spans as sp


def read(rec):
    spans = sp.recorded()
    levels = sp.named(spans, "path.level") if spans else []
    if not levels:
        return None
    return sum(s.end_ns - s.start_ns for s in levels) / len(levels) / 1e6
