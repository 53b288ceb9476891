"""The program's spans (`rpt_tpu_torch.tracing`) read against the traced
window: which span a stretch of the card's idle time fell in, and which
device operations started inside a span.

The spans are recorded while the window's profiler records, on the
profiler's clock (Unix nanoseconds), so the spans `recorded()` returns
are the window's. A program that has no `tracing` module, or recorded no
span, gives None, and every reader then reads nothing.
"""

from __future__ import annotations


def recorded():
    """The spans of the traced window, or None where there are none."""
    try:
        from rpt_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def intervals(spans) -> list:
    return [(s.start_ns, s.end_ns) for s in spans]


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def window(rec):
    """(start, end) in Unix ns of the traced window: the harness's first
    call's start to its last call's end."""
    ranges = rec["window"].ranges
    if not ranges:
        return None
    return min(r[1] for r in ranges), max(r[2] for r in ranges)


def idle(ops, start: int, end: int) -> list:
    """The card's idle intervals in [start, end]: the complement there of
    the union of the device operations' (name, start, end) intervals."""
    out, at = [], start
    for s, e in merged((max(s, start), min(e, end)) for _, s, e in ops if e > start and s < end):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < end:
        out.append((at, end))
    return out


def overlap_ns(a, b) -> int:
    """Length of the intersection of two unions of intervals."""
    a, b = merged(a), merged(b)
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(rec, name: str):
    """100 x the card's idle time inside the spans ``name`` / all its idle
    time in the window; None where there is nothing to read."""
    spans, win = recorded(), window(rec)
    if spans is None or win is None or not rec["ops"]:
        return None
    inside = named(spans, name)
    gaps = idle(rec["ops"], *win)
    total = sum(e - s for s, e in gaps)
    if not inside or total <= 0:
        return None
    return 100.0 * overlap_ns(gaps, intervals(inside)) / total


def device_ns_starting_in(ops, spans) -> int:
    """Device time of the operations whose start falls inside one of the
    spans (each operation counted once)."""
    inside = merged(intervals(spans))
    total, j = 0, 0
    for _, s, e in ops:  # sorted by start
        while j < len(inside) and inside[j][1] < s:
            j += 1
        if j < len(inside) and inside[j][0] <= s:
            total += e - s
    return total


def self_ns(span, spans, child: str) -> int:
    """A span's duration less that of its children named ``child``."""
    kids = [s for s in spans if s.parent == span.id and s.name == child]
    return (span.end_ns - span.start_ns) - sum(s.end_ns - s.start_ns for s in kids)
