"""CPU tests of the skybox_photons cell (`skybox_photons.render`): its
files found by name, the scene module's description and renderer at a
tiny size, a whole run at that size that comes out correct and one with
the timed path broken that does not, the lower-precision control against
the limit, K-knn's bound against a hand count, and the three new
readers on synthetic spans and device operations, which read nothing
where the program recorded no ``photon.estimate`` span."""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import rpt_tpu_torch.integrators.photon as port_photon  # noqa: E402
from perfbench import run  # noqa: E402
from perfbench.harness import check, port_scene, spec, traffic  # noqa: E402
from perfbench.rooflines import knn  # noqa: E402
from rpt_tpu_torch.vec import Vec3  # noqa: E402

CELL = "skybox_photons.render"
# 12x10 pixels, 2 samples, 12,000 photons (watts x photons kept at 100 W)
TINY = {"width": 12, "height": 10,
        "settings": {"photonmap": {"photons": 12_000, "samples": 2, "watts": 100.0 / 12_000}}}
NEW = ("photon.volume_point_ms", "idle.in_volume_point_pct", "knn.roofline_pct")
# the accepted metrics of the renders loop that this cell reports as well
SHARED = ("idle_pct.render", "photon.shoot_s", "photon.trace_s", "photon.shoot_level_ms",
          "idle.in_shoot_pct")
MS = 1_000_000  # ns


def _cell():
    return spec.cell(spec.benchmark(), CELL)


def _desc(seed, overrides=TINY):
    cell = _cell()
    config = run._merge(cell["config"], overrides)
    settings = config["settings"][cell["traffic"]["settings"]]
    return spec.module("scenes", cell["workload"]["config"]).describe(config, settings, seed)


def test_the_cell_loads_by_name():
    cell = _cell()
    assert cell["workload"]["chips"] == 1 and cell["config"]["name"] == "skybox_photons"
    assert cell["config"]["reduced"] == [] and cell["config"]["assumed"] == []
    assert (cell["traffic"]["loop"], cell["traffic"]["settings"]) == ("renders", "photonmap")
    assert cell["check"]["reference"] == "pointquery" and cell["check"]["renders"] == 1
    assert {m["name"] for m in cell["end_to_end"]} == {"render_s", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == set(NEW) | set(SHARED)
    settings = cell["config"]["settings"]["photonmap"]
    assert (settings["samples"], settings["photons"], settings["gather_size"],
            settings["gather_size_volume"]) == (100, 10_000_000, 50, 50)
    assert settings["watts"] * settings["photons"] == pytest.approx(100.0, rel=1e-15)
    scene = spec.module("scenes", "skybox_photons")
    assert port_scene.builder(scene) is scene.build_renderer


def test_the_description_and_the_renderer_at_a_tiny_size():
    desc = _desc(7)
    assert (desc["width"], desc["height"], desc["filter_radius"]) == (12, 10, 1)
    meshes = [o for o in desc["objects"] if o["shape"] == "mesh"]
    assert sum(len(o["vertices"]) for o in meshes) == 20
    assert [o.get("light", False) for o in desc["objects"]] == [False] * 11 + [True]
    assert desc["environment"] == {"kind": "color", "color": 0x87CEEB}
    r = spec.module("scenes", "skybox_photons").build_renderer(desc, 7, "cpu")
    assert (r.width_, r.height_, r.filter_.radius, r.seed_) == (12, 10, 1, 7)
    scene = r.compiled
    assert (scene.n_tris, scene.n_cubes, len(scene.lights), len(scene.media)) == (20, 2, 1, 1)


def _run(capsys, seed=2_147_483_693):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1", "--trace", "0"],
                  device="cpu", overrides=TINY)
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    result = _run(capsys)
    assert result["correct"] is True
    assert result["check"]["mismatch_share"]["value"] == 0.0
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"render_s", "setup_s"}


def test_an_altered_answer_is_not_correct(capsys, monkeypatch):
    original = port_photon.estimate_indirect

    def altered(*args, **kwargs):
        color = original(*args, **kwargs)
        return Vec3(*(c * 1.01 for c in (color.x, color.y, color.z)))

    monkeypatch.setattr(port_photon, "estimate_indirect", altered)
    result = _run(capsys)
    assert result["correct"] is False
    assert result["check"]["mismatch_share"]["value"] > _cell()["check"]["limit"]


def test_the_lower_precision_control_fails_the_limit():
    seed = 7_000_000_019
    desc, cell = _desc(seed), _cell()
    loop = spec.module("traffic", "renders")
    reference = spec.module("reference", "pointquery")
    lanes = [(seed, np.arange(desc["width"] * desc["height"]))]
    expected = loop.recompute(reference, desc, seed, lanes, "cpu", torch.float32)
    control = loop.recompute(reference, desc, seed, lanes, "cpu", torch.bfloat16)
    chk = cell["check"]
    assert check.mismatch_share(control, expected, chk["rtol"], chk["atol"]) > 3 * chk["limit"]


def test_knn_bound_against_a_hand_count_and_its_share():
    """`rooflines/knn.py` counts as `chip_smoke.py::_gather_bound` does: the
    distinct answered points (16-byte rows), the queries, and 8 bytes an
    answer, the invalid answers' index 0 not counted where no valid answer
    names point 0."""
    n, k, points = 1000, 50, 40_000
    grid = types.SimpleNamespace(n=points)
    queries = torch.zeros(n, 3)
    idx = (torch.arange(n * k) % 3000 + 1).reshape(n, k)
    valid = idx <= 2500  # points 1..2500 answer
    outs = (torch.where(valid, idx, 0), torch.zeros(n, k), valid)
    by_hand = (2500 * 16 + n * 12 + n * k * 8) / 3.35e12
    bound = float(knn.bound_s((grid, queries, k), {}, outs))
    assert bound == pytest.approx(by_hand)
    assert float(knn.bound_s((grid, queries), {"k": k}, outs)) == pytest.approx(by_hand)
    assert knn.bound_s((grid, queries[:0], k), {}, outs) == 0.0
    assert knn.bound_s((types.SimpleNamespace(n=0), queries, k), {}, outs) == 0.0
    few = (torch.zeros(2, 1, dtype=torch.int64), torch.zeros(2, 1), torch.ones(2, 1) > 0)
    assert float(knn.bound_s((grid, queries[:2], 1), {}, few)) == pytest.approx(
        max((16 + 24 + 16) / 3.35e12, 16 / 67e12))
    kernels = [("void (anonymous namespace)::knn_query_kernel<WarpListR<2>, false>(Grid)", 0,
                400_000),
               ("void (anonymous namespace)::knn_query_kernel<WarpListR<2>, false>(Grid)",
                500_000, 800_000),
               ("void (anonymous namespace)::knn_radius_kernel<10>(Grid)", 900_000, 1_900_000),
               ("void at::native::vectorized_elementwise_kernel<add>", 2_000_000, 9_000_000)]
    rec = {"kernels": kernels, "captured": {"rpt_tpu_torch.integrators.photon.knn_query":
                                            [bound, bound]}}
    share = spec.module("metrics", "knn.roofline_pct").read(rec)
    assert share == pytest.approx(100.0 * 2 * bound / 700_000e-9)
    rec["captured"]["rpt_tpu_torch.integrators.photon.knn_query"] = [
        knn.bound_s((grid, queries, k), {}, outs), 0.0]  # a 0-d tensor and an empty call
    assert spec.module("metrics", "knn.roofline_pct").read(rec) == pytest.approx(
        100.0 * bound / 700_000e-9)
    assert spec.module("metrics", "knn.roofline_pct").CAPTURE == {
        "rpt_tpu_torch.integrators.photon.knn_query": knn.bound_s}


def _span(name, start_ms, end_ms, sid, parent=None, lanes=None):
    return types.SimpleNamespace(name=name, id=sid, parent=parent, request=1,
                                 start_ns=int(start_ms * MS), end_ns=int(end_ms * MS),
                                 launches={}, lanes=lanes)


def _rec():
    # window 0-100 ms; busy 5-10, 40-45, 70-80: idle 0-5, 10-40, 45-70, 80-100 (80 ms)
    win = traffic.Window()
    win.ranges = [("render", 0, 100 * MS)]
    ops = [("k", 5 * MS, 10 * MS), ("k", 40 * MS, 45 * MS), ("k", 70 * MS, 80 * MS)]
    return {"ops": ops, "kernels": ops, "window": win, "captured": {}}


def test_the_span_readers_on_a_recorded_fixture_and_on_a_program_without_the_span(monkeypatch):
    from rpt_tpu_torch import tracing

    spans = [_span("photon_render", 0, 100, 1),
             _span("photon.estimate", 20, 50, 2, 1),  # idle 20-40, 45-50: 25 ms
             _span("intersect.closest", 20, 25, 3, 2),  # idle 20-25: 5 ms
             _span("photon.gather_volume", 26, 28, 4, 2),
             _span("photon.estimate", 60, 70, 5, 1),  # idle 60-70: 10 ms
             _span("intersect.closest", 60, 62, 6, 5),  # idle 60-62: 2 ms
             _span("intersect.closest", 85, 95, 7, 1)]  # outside any estimate: not subtracted
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    read = {name: spec.module("metrics", name).read for name in NEW}
    assert read["photon.volume_point_ms"](_rec()) == pytest.approx((25 + 8) / 2)
    assert read["idle.in_volume_point_pct"](_rec()) == pytest.approx(100.0 * (35 - 7) / 80)
    assert read["knn.roofline_pct"](_rec()) is None  # no call captured
    # a program that ran no photon camera pass: the path tracer's spans
    spans[:] = [_span("sample", 0, 100, 1), _span("intersect.closest", 22, 24, 2, 1)]
    assert read["photon.volume_point_ms"](_rec()) is None
    assert read["idle.in_volume_point_pct"](_rec()) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read["photon.volume_point_ms"](_rec()) is None
    assert read["idle.in_volume_point_pct"](_rec()) is None
