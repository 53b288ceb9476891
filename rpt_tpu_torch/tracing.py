"""Spans: where the program was on the host while the card ran or idled.

A span names one piece of a layer's work: a `Renderer.sample` call, a
level of the path tracer, a level of the photon shoot, an intersection
query. Spans record only while a `torch.profiler` session records (the
profiler's own flag, ``torch.autograd.profiler._is_profiler_enabled``),
so they are on exactly where the profiler's device events are: an
operator's session, `Renderer.profile`, a benchmark's traced window.

With recording off, `span` returns one shared object whose enter and exit
do nothing: no allocation, no clock read, never a device sync. With it
on, a span keeps (`Span`) its name, id, its parent's id, a request id (a
root span's own id, shared by every span under it: one `Renderer.sample`
or `photon_render` call), its start and end on `time.time_ns()` (the
Unix-epoch clock the profiler writes its events on; the card's own
timestamps, converted to it, can stray by a fraction of a millisecond
over a long session), the launches of each kernel
wrapper over it (the difference of its ``.launches`` counter, `COUNTERS`)
and, where the caller already holds the number on the host, its live
lanes. A span never reads a tensor: counts that live on the card are left
out.

Spans are kept in this process's memory until `clear`, at most `CAP` of
them (`dropped` counts the rest); nothing is written during a run.
`spans()` returns them; `chrome_events` turns them into Chrome trace
events, which `Renderer.profile` adds to its trace.

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        renderer.sample(1, buffer)
    for s in tracing.spans():
        print(s.name, s.parent, (s.end_ns - s.start_ns) / 1e6, s.launches, s.lanes)
"""

from __future__ import annotations

import importlib
import itertools
import time

import torch.autograd.profiler as _profiler

CAP = 1 << 18

# (module, wrapper) of every kernel wrapper whose ``.launches`` a span
# records: K-rng, K-prim, K1/K2, K-knn, K-sweep, K-dense, K-shoot
COUNTERS = (
    ("rpt_tpu_torch.ops.threefry", "threefry_fold"),
    ("rpt_tpu_torch.ops.threefry", "threefry_split"),
    ("rpt_tpu_torch.ops.threefry", "threefry_uniform"),
    ("rpt_tpu_torch.ops.threefry", "threefry_bits"),
    ("rpt_tpu_torch.ops.threefry", "threefry_draw"),
    ("rpt_tpu_torch.ops.prim_hit", "prim_closest_hit"),
    ("rpt_tpu_torch.ops.prim_hit", "prim_any_hit"),
    ("rpt_tpu_torch.ops.bvh_traverse", "bvh_closest_hit"),
    ("rpt_tpu_torch.ops.bvh_traverse", "bvh_any_hit"),
    ("rpt_tpu_torch.accel.knn", "knn_query"),
    ("rpt_tpu_torch.accel.knn", "knn_radius"),
    ("rpt_tpu_torch.ops.sphere_sweep", "sphere_sweep"),
    ("rpt_tpu_torch.ops.dense_tri_hit", "dense_closest_hit"),
    ("rpt_tpu_torch.ops.dense_tri_hit", "dense_any_hit"),
    ("rpt_tpu_torch.ops.photon_shoot", "shoot_level"),
)

_records: list = []
_open: list = []  # the spans entered and not yet left, innermost last
_ids = itertools.count(1)
_dropped = 0
_modules = None  # the modules of COUNTERS, imported at the first recorded span


def _counts() -> tuple:
    """Every wrapper's ``.launches`` now. The wrapper is looked up in its
    module on each read: a caller may have replaced it by a wrapper of its
    own that carries the counter on."""
    global _modules
    if _modules is None:
        _modules = [importlib.import_module(m) for m, _ in COUNTERS]
    return tuple(getattr(mod, fn).launches for mod, (_, fn) in zip(_modules, COUNTERS))


class Span:
    """One recorded span. ``launches`` maps a wrapper's name to the
    launches it made over the span (wrappers that made none left out);
    ``lanes`` is None where the caller gave no count."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "launches", "lanes",
                 "_before")

    def __init__(self, name: str, lanes):
        self.name, self.lanes = name, lanes

    def __enter__(self):
        parent = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        self._before = _counts()
        self.start_ns = time.time_ns()
        _open.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        global _dropped
        self.end_ns = time.time_ns()
        after = _counts()
        self.launches = {fn: b - a for (_, fn), a, b in zip(COUNTERS, self._before, after)
                         if b != a}
        self._before = None
        _open.pop()  # `with` leaves spans in the reverse order it entered them
        if len(_records) < CAP:
            _records.append(self)
        else:
            _dropped += 1
        return False


class _Off:
    """What `span` returns with recording off: one object, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def span(name: str, lanes=None):
    """A context manager over one piece of work named ``name``: a `Span`
    while the profiler records, else a shared object that does nothing.
    ``lanes`` is a live-lane count the caller already holds on the host."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, lanes)


def spans() -> list:
    """The spans recorded since the last `clear`, in the order they ended
    (children before their parent)."""
    return list(_records)


def dropped() -> int:
    """Spans left out since the last `clear`: ended past `CAP`."""
    return _dropped


def clear():
    global _dropped
    _records.clear()
    _dropped = 0


def chrome_events(records, base_ns: int, pid: int) -> list:
    """``records`` as Chrome trace complete events ("X") on a track of
    their own (thread 0 of ``pid``, named "rpt_tpu_torch spans"), times in
    microseconds after ``base_ns`` (a torch trace's
    ``baseTimeNanoseconds``), as the profiler writes its own events."""
    tid = 0
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": "rpt_tpu_torch spans"}}]
    for s in records:
        args = {"id": s.id, "parent": s.parent, "request": s.request, "launches": s.launches}
        if s.lanes is not None:
            args["lanes"] = s.lanes
        events.append({"ph": "X", "cat": "rpt_span", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": args})
    return events
