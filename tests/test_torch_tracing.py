"""The port's spans (`rpt_tpu_torch.tracing`) on the CPU: nothing is
recorded without a profiler session, and the off path reads no clock and
keeps nothing; under `torch.profiler` a volumetric pass and a point-beam
render give the span trees the benchmark's readers and `Renderer.profile`
rely on (one root a call and its request id, live lanes level by level,
the photon phase spans around `phase_seconds`' readings), launch deltas
are the differences of the launch table, the image is bit-identical with
recording on and off, and `Renderer.profile` writes the spans of a pass
and of a photon render into its Chrome trace on the profiler's time
base."""

import collections
import itertools
import json
import os
import sys
import time
import tracemalloc

import numpy as np
import pytest
import torch

import rpt_tpu_torch as tr
from rpt_tpu_torch import tracing

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_sphere  # noqa: E402
import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402
import torch_volumetric_pathtrace_lampshade as tvol  # noqa: E402

SIZE = 8


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh():
    tracing.clear()
    yield
    tracing.clear()


def _pass(profiled: bool) -> tr.Buffer:
    r = tvol.renderer("cpu", size=SIZE, sample=1, seed=3)
    buffer = tr.Buffer(SIZE, SIZE)
    if profiled:
        with _profiled():
            r.sample(1, buffer)
    else:
        r.sample(1, buffer)
    return buffer


def _render(profiled: bool):
    r = tlamp.renderer("cpu", size=SIZE, sample=2, photons=2000, seed=5)
    if profiled:
        with _profiled():
            r.photon_point_query_beam_render(2000)
    else:
        r.photon_point_query_beam_render(2000)
    return r


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start_ns)


def _check_nesting(spans):
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.request == p.request
        else:
            assert s.request == s.id


def test_nothing_is_recorded_without_a_profiler():
    _pass(profiled=False)
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert tracing.span("sample") is tracing.span("path.level", 7) is tracing._OFF


class _Unreadable:
    """A launch table whose every read fails."""

    def __getattr__(self, name):
        raise AssertionError("read with recording off")


def test_the_off_path_reads_no_clock_and_keeps_nothing(monkeypatch):
    def forbidden(*args):
        raise AssertionError("read with recording off")

    spans = [("sample", None), ("path.level", 16384), ("intersect.closest", None)]

    def enter_and_leave(n):
        for _ in itertools.repeat(None, n):
            for name, lanes in spans:
                with tracing.span(name, lanes):
                    pass

    enter_and_leave(1)
    for name in ("time_ns", "perf_counter", "monotonic_ns"):
        monkeypatch.setattr(time, name, forbidden)
    monkeypatch.setattr(tracing, "LAUNCHES", _Unreadable())
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    tracemalloc.start()
    try:
        peaks = []
        for n in (1, 10_000):
            tracemalloc.reset_peak()
            before, _ = tracemalloc.get_traced_memory()
            enter_and_leave(n)
            after, peak = tracemalloc.get_traced_memory()
            assert after == before
            peaks.append(peak - before)
    finally:
        tracemalloc.stop()
    assert peaks[0] == peaks[1]  # 30,000 spans need no more memory than 3
    assert tracing.spans() == []


def test_a_volumetric_pass_gives_one_tree():
    _pass(profiled=True)
    spans = tracing.spans()
    _check_nesting(spans)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "sample" and {s.request for s in spans} == {root.id}
    assert [s.name for s in _children(spans, root)] == [
        "frontend.camera", "path.chunk", "frontend.gather_out", "frontend.accumulate"]
    (chunk,) = [s for s in spans if s.name == "path.chunk"]
    levels = _children(spans, chunk)
    assert levels and {s.name for s in levels} == {"path.level"}
    lanes = [s.lanes for s in levels]
    assert lanes[0] == SIZE * SIZE and lanes[-1] >= 1
    assert all(a >= b for a, b in zip(lanes, lanes[1:])) and lanes[-1] < lanes[0]
    for level in levels:
        assert [s.name for s in _children(spans, level)] == [
            "intersect.closest", "intersect.occluded", "intersect.occluded", "path.compact"]
    assert all(s.launches == {} for s in spans)  # the CPU path launches no kernel
    assert tracing.dropped() == 0


def test_a_point_beam_render_gives_the_shoot_build_and_trace_subtrees():
    r = _render(profiled=True)
    spans = tracing.spans()
    _check_nesting(spans)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "photon_render"
    shoot, build, trace, accumulate = _children(spans, root)
    assert [s.name for s in (shoot, build, trace, accumulate)] == [
        "photon.shoot", "photon.build", "photon.trace", "frontend.accumulate"]
    levels = _children(spans, shoot)
    assert {s.name for s in levels} == {"photon.shoot_level"}
    assert levels[0].lanes == 2000 and all(a.lanes >= b.lanes for a, b in zip(levels, levels[1:]))
    for level in levels:
        assert [s.name for s in _children(spans, level)] == ["intersect.closest"]
    assert [s.name for s in _children(spans, build)] == ["photon.knn_radius",
                                                          "photon.sphere_table"]
    samples = _children(spans, trace)
    assert [s.name for s in samples] == ["photon.sample"] * 2 + ["frontend.gather_out"]
    for sample in samples[:2]:
        camera, estimate = _children(spans, sample)
        assert (camera.name, estimate.name) == ("frontend.camera", "photon.estimate")
        inner = _children(spans, estimate)
        assert [s.name for s in inner] == ["intersect.closest", "photon.sweep", "photon.gather",
                                           "photon.occlusion"]
        assert [s.name for s in _children(spans, inner[-1])] == ["intersect.occluded"]
    # a phase span encloses the two readings of its `phase_seconds`, a few
    # microseconds apart from them (1 ms leaves room for a preemption)
    for s in (shoot, build, trace):
        extra = (s.end_ns - s.start_ns) / 1e9 - r.phase_seconds[s.name.split(".")[1]]
        assert -1e-6 <= extra < 1e-3


def test_launch_deltas_are_the_wrappers_counters_differences(monkeypatch):
    # the process's table back as it was after the test
    monkeypatch.setattr(tracing, "LAUNCHES", collections.Counter(threefry_draw=40))
    with _profiled():
        with tracing.span("outer"):
            for _ in range(3):
                tracing.count("threefry_draw")
            with tracing.span("inner"):
                tracing.count("prim_closest_hit")
                tracing.count("knn_query")
                tracing.count("knn_query")
            tracing.count("threefry_fold")
        with tracing.span("quiet"):
            pass
    inner, outer, quiet = tracing.spans()
    assert inner.launches == {"prim_closest_hit": 1, "knn_query": 2}
    assert outer.launches == {"threefry_draw": 3, "prim_closest_hit": 1, "knn_query": 2,
                              "threefry_fold": 1}
    assert quiet.launches == {} and inner.parent == outer.id and quiet.parent is None
    assert tracing.LAUNCHES["threefry_draw"] == 43


def test_the_spans_stop_at_the_cap(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with _profiled():
        for _ in range(5):
            with tracing.span("x"):
                pass
    assert len(tracing.spans()) == 3 and tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_the_image_is_bit_identical_with_recording_on_and_off():
    assert np.array_equal(_pass(profiled=True).sum, _pass(profiled=False).sum)
    on, off = _render(profiled=True), _render(profiled=False)
    assert np.array_equal(on._last_buffer.sum, off._last_buffer.sum)


def test_profile_writes_the_spans_into_its_trace(tmp_path):
    r = torch_sphere.renderer("cpu", 16, 12, 2, 7).profile(str(tmp_path))
    r.render()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "rpt_span"]
    assert {e["name"] for e in mine} >= {"sample", "frontend.camera", "path.chunk", "path.level",
                                         "intersect.closest", "frontend.gather_out"}
    (track,) = {(e["pid"], e["tid"]) for e in mine}
    assert {"ph": "M", "name": "thread_name", "pid": track[0], "tid": track[1],
            "args": {"name": "rpt_tpu_torch spans"}} in events
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(e["ph"] == "X" for e in mine)
    (sample,) = [e for e in mine if e["name"] == "sample"]
    # the profiler's own events of the pass lie inside its root span
    slack_us = 50.0
    assert min(e["ts"] for e in ops) >= sample["ts"] - slack_us
    assert max(e["ts"] + e["dur"] for e in ops) <= sample["ts"] + sample["dur"] + slack_us
    assert len(tracing.spans()) == len(mine)


def test_profile_writes_a_photon_renders_spans_into_its_trace(tmp_path):
    r = tlamp.renderer("cpu", size=SIZE, sample=2, photons=2000, seed=5).profile(str(tmp_path))
    r.photon_point_query_beam_render(2000)
    assert os.listdir(tmp_path) == ["photon_render_point_beam.trace.json"]
    with open(tmp_path / "photon_render_point_beam.trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "rpt_span"]
    assert {e["name"] for e in mine} == {
        "photon_render", "photon.shoot", "photon.shoot_level", "photon.build",
        "photon.knn_radius", "photon.sphere_table", "photon.trace", "photon.sample",
        "photon.estimate", "photon.gather", "photon.occlusion", "photon.sweep",
        "frontend.camera", "frontend.gather_out", "frontend.accumulate", "intersect.closest",
        "intersect.occluded"}
    (root,) = [e for e in mine if e["name"] == "photon_render"]
    assert all(e["args"]["request"] == root["args"]["id"] for e in mine)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    slack_us = 50.0
    assert ops and min(e["ts"] for e in ops) >= root["ts"] - slack_us
    assert max(e["ts"] + e["dur"] for e in ops) <= root["ts"] + root["dur"] + slack_us
    # one-shot: the next render is not recorded
    tracing.clear()
    r.photon_point_query_beam_render(2000)
    assert tracing.spans() == [] and len(os.listdir(tmp_path)) == 1
