"""CPU tests of the readers of the program's spans (`harness/spans.py` and
the seven `program_span` metrics) on synthetic spans and device
operations: the idle intervals and their overlap with spans whose edges
cut through gaps, self time as a span less its children, the per-pass
means, and nothing read where no span was recorded."""

from __future__ import annotations

import os
import sys
import types

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

from perfbench.harness import spans as sp  # noqa: E402
from perfbench.harness import spec, traffic  # noqa: E402

MS = 1_000_000  # ns
READERS = ("frontend.host_ms_per_pass", "path.host_ms_per_level", "rng.launches_per_pass",
           "intersect.span_device_ms_per_pass", "idle.in_path_pct", "photon.shoot_level_ms",
           "idle.in_shoot_pct")


class _Spans:
    """Synthetic spans, ids in the order they are made."""

    def __init__(self):
        self.all = []

    def add(self, name, start_ms, end_ms, parent=None, launches=None, lanes=None):
        s = types.SimpleNamespace(name=name, id=len(self.all) + 1,
                                  parent=parent.id if parent else None,
                                  request=parent.request if parent else len(self.all) + 1,
                                  start_ns=int(start_ms * MS), end_ns=int(end_ms * MS),
                                  launches=launches or {}, lanes=lanes)
        self.all.append(s)
        return s


def _rec(ops_ms, ranges_ms, passes=1):
    win = traffic.Window()
    win.ranges = [("pass", int(s * MS), int(e * MS)) for s, e in ranges_ms]
    ops = sorted(((name, int(s * MS), int(e * MS)) for name, s, e in ops_ms), key=lambda op: op[1])
    return {"ops": ops, "kernels": ops, "window": win, "passes": passes}


@pytest.fixture
def recorded(monkeypatch):
    """Makes `rpt_tpu_torch.tracing.spans()` return the spans given."""
    from rpt_tpu_torch import tracing

    def give(spans):
        monkeypatch.setattr(tracing, "spans", lambda: list(spans.all))

    return give


def _read(name, rec):
    return spec.module("metrics", name).read(rec)


def test_idle_intervals_are_the_complement_of_the_busy_union():
    ops = [("a", 10, 20), ("b", 15, 30), ("c", 50, 60), ("d", 95, 120), ("e", -5, 2)]
    assert sp.idle(ops, 0, 100) == [(2, 10), (30, 50), (60, 95)]
    assert sp.idle([], 0, 100) == [(0, 100)]
    assert sp.merged([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
    assert sp.overlap_ns([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == 5 + 5 + 2
    assert sp.overlap_ns([(0, 10)], [(2, 4), (3, 6)]) == 4  # overlapping spans count once


def test_idle_share_in_spans_whose_edges_cut_through_gaps(recorded):
    # window 0-100 ms; busy 10-20, 30-60, 90-95: idle 0-10, 20-30, 60-90, 95-100 (55 ms)
    rec = _rec([("k", 10, 20), ("k", 30, 60), ("k", 90, 95)], [(0, 50), (50, 100)], passes=2)
    spans = _Spans()
    for r0, r1 in ((0, 50), (50, 100)):
        root = spans.add("sample", r0, r1)
        chunk = spans.add("path.chunk", r0, r1, root)
        if r0 == 0:
            spans.add("path.level", 5, 25, chunk)  # cuts the gaps 0-10 and 20-30: 5 + 5
        else:
            spans.add("path.level", 55, 92, chunk)  # the gap 60-90 whole, busy 90-92
    spans.add("photon.shoot", 85, 100)  # 85-90 and 95-100
    recorded(spans)
    assert _read("idle.in_path_pct", rec) == pytest.approx(100.0 * 40 / 55)
    assert _read("idle.in_shoot_pct", rec) == pytest.approx(100.0 * 10 / 55)
    # the readers' idle time is the harness's: the window less the busy union
    w0, w1 = sp.window(rec)
    assert (w0, w1) == (0, 100 * MS)
    assert sum(e - s for s, e in sp.idle(rec["ops"], w0, w1)) == 55 * MS


def test_front_end_time_is_the_sample_span_less_its_chunks(recorded):
    spans = _Spans()
    a = spans.add("sample", 0, 100)
    spans.add("frontend.camera", 0, 10, a)  # not a chunk: stays in the front end's time
    spans.add("path.chunk", 10, 40, a)
    spans.add("path.chunk", 50, 80, a)
    b = spans.add("sample", 100, 130)
    spans.add("path.chunk", 105, 125, b)
    spans.add("path.chunk", 1, 2, spans.add("sample", 200, 201))  # another call's child
    recorded(spans)
    rec = _rec([], [(0, 201)], passes=3)
    assert _read("frontend.host_ms_per_pass", rec) == pytest.approx((40 + 10 + 0) / 3)
    assert sp.self_ns(a, spans.all, "path.chunk") == 40 * MS


def test_per_pass_and_per_level_means(recorded):
    spans = _Spans()
    for i, launches in enumerate(({"threefry_draw": 10, "prim_closest_hit": 3},
                                  {"threefry_draw": 4, "threefry_fold": 2})):
        root = spans.add("sample", 100 * i, 100 * i + 90, launches=launches)
        chunk = spans.add("path.chunk", 100 * i, 100 * i + 80, root)
        for k, lanes in enumerate((16384, 9000, 12)):
            spans.add("path.level", 100 * i + 10 * k, 100 * i + 10 * k + 2 + k, chunk, lanes=lanes)
    shoot = spans.add("photon.shoot", 300, 400)
    for k in range(4):
        spans.add("photon.shoot_level", 300 + 10 * k, 300 + 10 * k + 1.5, shoot)
    recorded(spans)
    rec = _rec([], [(0, 400)], passes=2)
    assert _read("rng.launches_per_pass", rec) == pytest.approx((10 + 4 + 2) / 2)
    assert _read("path.host_ms_per_level", rec) == pytest.approx((2 + 3 + 4) / 3)
    assert _read("photon.shoot_level_ms", rec) == pytest.approx(1.5)


def test_intersection_time_counts_the_ops_that_start_inside_its_spans(recorded):
    spans = _Spans()
    root = spans.add("sample", 0, 100)
    level = spans.add("path.level", 0, 100, root)
    closest = spans.add("intersect.closest", 10, 20, level)
    spans.add("intersect.occluded", 12, 14, closest)  # nested: its ops count once
    spans.add("intersect.occluded", 40, 50, level)
    spans.add("sample", 100, 200)
    recorded(spans)
    ops = [("prim_closest_hit_kernel", 11, 12.5),  # inside
           ("elementwise", 12.5, 13.0),  # inside both
           ("elementwise", 19.5, 24.0),  # starts inside, ends after: all of it
           ("elementwise", 8.0, 11.0),  # starts before: not counted
           ("prim_any_hit_kernel", 40.0, 41.0),
           ("elementwise", 60.0, 70.0)]
    rec = _rec(ops, [(0, 100), (100, 200)], passes=2)
    assert _read("intersect.span_device_ms_per_pass", rec) == pytest.approx(
        (1.5 + 0.5 + 4.5 + 1.0) / 2)


def test_nothing_is_read_where_no_span_was_recorded(recorded, monkeypatch):
    rec = _rec([("k", 1, 2)], [(0, 10)])
    recorded(_Spans())
    for name in READERS:
        assert _read(name, rec) is None, name
    # a program without the tracing module (the parent of the commit that added it)
    import rpt_tpu_torch

    spans = _Spans()
    spans.add("path.level", 1, 2, spans.add("sample", 0, 5))
    recorded(spans)
    assert sp.recorded()
    monkeypatch.delattr(rpt_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "rpt_tpu_torch.tracing", None)
    assert sp.recorded() is None
    for name in READERS:
        assert _read(name, rec) is None, name


def test_readers_of_one_cell_read_nothing_in_the_other(recorded):
    spans = _Spans()
    spans.add("photon.shoot_level", 1, 2, spans.add("photon.shoot", 0, 5))
    recorded(spans)
    rec = _rec([("k", 1, 2)], [(0, 10)])
    for name in ("frontend.host_ms_per_pass", "path.host_ms_per_level", "rng.launches_per_pass",
                 "intersect.span_device_ms_per_pass", "idle.in_path_pct"):
        assert _read(name, rec) is None, name
    assert _read("photon.shoot_level_ms", rec) == pytest.approx(1.0)


def test_the_new_metrics_are_entries_of_the_benchmark():
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        cell = "lampshade.beamphoton" if name in ("photon.shoot_level_ms",
                                                  "idle.in_shoot_pct") else "lampshade.pathtrace"
        assert m["workloads"] == [cell]
        assert name in {x["name"] for x in spec.cell(bench, cell)["per_layer"]}
