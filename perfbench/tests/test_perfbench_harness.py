"""CPU tests of the benchmark's harness: files found by name, the metric
arithmetic on synthetic records, the rooflines against hand counts, and
the import guard. None needs a card."""

from __future__ import annotations

import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

from perfbench import run  # noqa: E402
from perfbench.harness import port_scene, spec, stats, trace, traffic  # noqa: E402
from perfbench.rooflines import k1, ksweep, peaks  # noqa: E402

BENCH = spec.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(name):
    cell = spec.cell(BENCH, name)
    loop = spec.module("traffic", cell["traffic"]["loop"])
    for fn in ("warm_up", "run", "answers", "recompute"):
        assert callable(getattr(loop, fn))
    reference = spec.module("reference", cell["check"]["reference"])
    assert callable(getattr(reference, {"passes": "radiance", "renders": "render_pixels"}[
        cell["traffic"]["loop"]]))
    scene = spec.module("scenes", cell["workload"]["config"])
    assert callable(scene.describe)
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)
    assert {"setup_s"} < {m["name"] for m in cell["end_to_end"]}
    assert cell["per_layer"]
    assert 0.0 < cell["check"]["limit"] < 1.0


@pytest.mark.parametrize("loop,reference,fn", [("passes", "path", "radiance"),
                                               ("passes", "surface", "radiance"),
                                               ("renders", "photon", "render_pixels")])
def test_a_loop_and_a_reference_load_by_name(loop, reference, fn):
    mod = spec.module("traffic", loop)
    assert mod.__name__ == f"perfbench.traffic.{loop}"
    assert callable(getattr(spec.module("reference", reference), fn))
    with pytest.raises(FileNotFoundError):
        spec.module("traffic", "no_such_loop")


@pytest.mark.parametrize("config,own", [("pegasus", True), ("lampshade", False),
                                        ("dragon", False)])
def test_a_scene_module_builds_the_renderer_where_it_defines_a_builder(config, own):
    scene = spec.module("scenes", config)
    build = port_scene.builder(scene)
    assert build is (scene.build_renderer if own else port_scene.build_renderer)


def test_every_configuration_file_is_its_own_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        config = spec.load_json(CHECKOUT, c["file"])
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]


def test_metrics_apply_to_the_cells_they_list():
    cell = spec.cell(BENCH, "lampshade.pathtrace")
    names = {m["name"] for m in cell["end_to_end"] + cell["per_layer"]}
    assert {"samples_per_s", "idle_pct.passes", "path.kernels_per_pass"} <= names
    assert not {"render_s", "idle_pct.render", "ksweep.roofline_pct"} & names
    cell = spec.cell(BENCH, "lampshade.beamphoton")
    names = {m["name"] for m in cell["end_to_end"] + cell["per_layer"]}
    assert {"render_s", "idle_pct.render", "photon.shoot_s", "photon.trace_s",
            "ksweep.roofline_pct", "setup_s", "photon.shoot_level_ms",
            "idle.in_shoot_pct"} == names
    cell = spec.cell(BENCH, "pegasus.passes")
    names = {m["name"] for m in cell["end_to_end"] + cell["per_layer"]}
    assert {"samples_per_s", "setup_s", "idle_pct.passes", "path.kernels_per_pass",
            "intersect.device_ms_per_pass", "intersect.span_device_ms_per_pass",
            "frontend.host_ms_per_pass", "path.host_ms_per_level", "rng.launches_per_pass",
            "k1.roofline_pct"} == names


def test_union_of_intervals():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert stats.union_length([]) == 0
    assert stats.union_length([(3, 4), (0, 10)]) == 10


def test_p95_is_over_every_pass():
    calls = [0.1] * 95 + [0.2] * 4 + [1.0]
    win = traffic.Window()
    win.calls_s = calls
    value = spec.module("metrics", "pass_ms.p95").read({"window": win})
    assert value == pytest.approx(stats.percentile(calls, 95) * 1e3)
    assert value == pytest.approx(105.0)  # 95th of 100: between the 95th and 96th values


class _Renderer:
    """Passes of a 4x2 image; pass 2 puts a NaN into pixel 5, pass 4 one
    into pixel 6, and each pass takes 10 ms."""

    width_, height_ = 4, 2

    def __init__(self):
        self.calls = 0

    def sample(self, iterations, buffer):
        self.calls += 1
        time.sleep(0.01)
        colors = np.ones((2, 4, 3))
        if self.calls in (2, 4):
            colors.reshape(-1, 3)[3 + self.calls // 2] = np.nan
        buffer.add_samples(colors)


@pytest.mark.parametrize("watched,failed", [(8, 2), (1, 1)], ids=["all_watched", "one_watched"])
def test_the_passes_loop_is_closed_and_counts_non_finite_passes(watched, failed):
    passes = spec.module("traffic", "passes")
    win = passes.run(_Renderer(), {}, {}, 0.1, 11, {"watch_pixels": watched})
    n = len(win.calls_s)
    assert n >= 5 and win.attempted == n and win.window_s >= 0.1
    assert win.window_s == pytest.approx(sum(win.calls_s), rel=0.2, abs=0.005)
    assert win.samples == n * 8
    assert win.non_finite == 2 and win.failed == failed
    assert win.kept["watched"].shape == (n + 1, watched, 3)


class _PhotonRenderer:
    """Photon renders of a 4x2 image, 30 ms each; render 3's image has a
    NaN."""

    width_, height_ = 4, 2
    seed_ = 5

    def __init__(self):
        self.calls = 0
        self.seeds = []

    def seed(self, v):
        self.seed_ = v
        self.seeds.append(v)
        return self

    def photon_point_query_beam_render(self, photons):
        self.calls += 1
        time.sleep(0.03)
        self._last_buffer = types.SimpleNamespace(sum=np.full((2, 4, 3), float(self.seed_ % 7)))
        if self.calls == 3:
            self._last_buffer.sum[1, 2, 0] = np.nan
        self.phase_seconds = {"shoot": 0.01 * self.calls, "build": 0.0, "trace": 0.02}


def test_the_renders_loop_counts_renders_seeds_and_non_finite_images():
    renders = spec.module("traffic", "renders")
    desc = {"render": {"integrator": "point_beam", "samples": 50, "photons": 1000}}
    r = _PhotonRenderer()
    win = renders.run(r, desc, {}, 0.1, 11, {"watch_pixels": 3})
    n = len(win.calls_s)
    assert n >= 3 and win.attempted == n and win.failed == 1 and win.non_finite == 1
    assert r.seeds == [renders.render_seed(11, i) for i in range(n)]
    assert len(set(r.seeds)) == n and renders.render_seed(11, -1) not in r.seeds
    assert win.samples == n * 50 * 8
    assert spec.module("metrics", "photon.shoot_s").read({"window": win}) == pytest.approx(
        0.01 * (n + 1) / 2)
    assert spec.module("metrics", "photon.trace_s").read({"window": win}) == pytest.approx(0.02)
    lanes, program = renders.answers(win, 11, {"renders": 2})
    assert len(lanes) == 2 and program.shape == (6, 3)
    i = renders.chosen(11, n, 2)[0]
    assert lanes[0][0] == renders.render_seed(11, i)
    np.testing.assert_array_equal(program[:3], float(renders.render_seed(11, i) % 7))


def test_render_s_is_the_whole_window_over_the_renders_it_finished():
    win = traffic.Window()
    win.calls_s, win.window_s = [2.0, 2.1, 2.4], 6.5  # the window ends with the render in flight
    assert spec.module("metrics", "render_s").read({"window": win}) == pytest.approx(6.5 / 3)
    win.calls_s = []
    assert spec.module("metrics", "render_s").read({"window": win}) is None


def test_rate_counts_all_samples_over_the_whole_window():
    win = traffic.Window()
    win.samples, win.window_s = 3 * 800 * 600, 0.5
    assert spec.module("metrics", "samples_per_s").read({"window": win}) == pytest.approx(2.88)


def _ops():
    # ns: two kernels overlapping, a gap, a copy, a K1 kernel
    return [("void vectorized_elementwise_kernel<add>", 0, 1000),
            ("void vectorized_elementwise_kernel<mul>", 500, 1500),
            ("Memcpy DtoH (Device -> Pinned)", 3000, 3500),
            ("void (anonymous namespace)::traverse_kernel<false, false, false>(Lanes)", 4000, 6000),
            ("void (anonymous namespace)::traverse_kernel<true, true, false>(Lanes)", 6000, 7000)]


def test_idle_share_kernels_and_intersection_time_from_synthetic_intervals():
    ops = _ops()
    rec = {"ops": ops, "kernels": trace.kernels(ops), "busy_s": trace.busy_s(ops),
           "traced_s": 10e-6, "passes": 2, "captured": {}}
    assert rec["busy_s"] == pytest.approx(5000e-9)
    assert spec.module("metrics", "idle_pct.passes").read(rec) == pytest.approx(50.0)
    assert spec.module("metrics", "path.kernels_per_pass").read(rec) == 2.0
    ms = spec.module("metrics", "intersect.device_ms_per_pass").read(rec)
    assert ms == pytest.approx(3000e-6 / 2)
    assert spec.module("metrics", "k1.roofline_pct").read(rec) is None  # no call captured
    rec["captured"] = {"rpt_tpu_torch.ops.bvh_traverse.bvh_closest_hit": [1e-6]}
    assert spec.module("metrics", "k1.roofline_pct").read(rec) == pytest.approx(50.0)


def test_readers_return_nothing_when_there_is_nothing_to_read():
    rec = {"ops": [], "kernels": [], "passes": 0, "captured": {}, "window": traffic.Window()}
    for name in ("idle_pct.passes", "path.kernels_per_pass", "intersect.device_ms_per_pass",
                 "k1.roofline_pct", "idle_pct.render", "ksweep.roofline_pct", "photon.shoot_s",
                 "photon.trace_s", "render_s"):
        assert spec.module("metrics", name).read(rec) is None


def test_breakdown_labels_gaps_by_host_range_and_the_op_before():
    ops = _ops()
    out = trace.breakdown(ops, [("pass", 0, 3600)])
    assert out["device_ops"][0][1] == pytest.approx(2000e-9)
    labels = dict(out["idle_gaps"])
    first = "pass: after void vectorized_elementwise_kernel<mul> (x1)"
    assert labels[first] == pytest.approx(1500e-9)
    assert labels["harness: after Memcpy DtoH (Device -> Pinned) (x1)"] == pytest.approx(500e-9)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_k1_bound_against_a_hand_count():
    n, n_nodes, n_leaves = 1000, 300, 125
    bvh = types.SimpleNamespace(nodes=torch.zeros(n_nodes, 16), leaves=torch.zeros(n_leaves, 80))
    origin, direction, best = torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n)
    outs = (torch.zeros(n), torch.zeros(n, dtype=torch.int32), torch.zeros(n), torch.zeros(n),
            torch.zeros(n))
    by_hand = (n * 12 + n * 12 + n * 4 + n_nodes * 64 + n_leaves * 320 + n * 20) / 3.35e12
    assert k1.bound_s((bvh, origin, direction, 1e-4, best), {}, outs) == pytest.approx(by_hand)
    # at one lane and no rows the 20 operations bound it
    assert peaks.bound_s(0, 20) == pytest.approx(20 / 67e12)


def test_ksweep_bound_against_a_hand_count_and_its_share():
    n, n_tiles = 1000, 40
    table = types.SimpleNamespace(records=torch.zeros(n_tiles * 256, 8),
                                  bounds=torch.zeros(n_tiles, 8))
    o, d, th, out = torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n), torch.zeros(n, 3)
    by_hand = (n * 12 + n * 12 + n * 4 + n_tiles * 256 * 32 + n_tiles * 32 + n * 12) / 3.35e12
    bound = ksweep.bound_s((o, d, th, table, 1e-3, torch.ones(3)), {}, out)
    assert bound == pytest.approx(by_hand)
    kernels = [("(anonymous namespace)::cull_tiles(float const*)", 0, 400),
               ("void (anonymous namespace)::sweep_tiles<false>(float const*)", 500, 1500),
               ("(anonymous namespace)::sum_slots(float const*)", 1500, 1600),
               ("void at::native::vectorized_elementwise_kernel<add>", 2000, 9000)]
    rec = {"kernels": kernels, "captured": {"rpt_tpu_torch.integrators.photon.sphere_sweep":
                                            [bound, bound]}}
    share = spec.module("metrics", "ksweep.roofline_pct").read(rec)
    assert share == pytest.approx(100.0 * 2 * bound / 1500e-9)


def test_import_guard_compares_whole_top_level_names():
    assert run.forbidden_modules({"rpt_tpu_torch": 1, "rpt_tpu_torch.ops": 1, "jaxtyping": 1,
                                  "numpy": 1}) == []
    found = run.forbidden_modules({"rpt_tpu.sampling": 1, "jax": 1, "jaxlib.xla": 1,
                                   "flax.linen": 1, "rpt_tpu_torch": 1})
    assert found == ["flax", "jax", "jaxlib", "rpt_tpu"]


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(CHECKOUT, "BENCHMARK.json")) < 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in layers
        assert set(m["workloads"]) <= set(layers[m["moves"]].get("workloads", m["workloads"]))
    json.dumps(BENCH)
