"""CPU tests of what decides ``correct``: the plain reference against the
port's CPU path at a tiny size, for each configuration; a whole run at a
tiny size that comes out correct; the same run with the timed path broken
underneath, once for each fault a cell can have, that comes out not
correct; and the lower-precision control, which fails the limit."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import rpt_tpu_torch as rpt  # noqa: E402
import rpt_tpu_torch.integrators.path as port_path  # noqa: E402
import rpt_tpu_torch.integrators.photon as port_photon  # noqa: E402
from perfbench import run  # noqa: E402
from perfbench.harness import check, port_scene, spec  # noqa: E402
from perfbench.reference import path as ref  # noqa: E402
from perfbench.reference import photon as ref_photon  # noqa: E402
from rpt_tpu_torch.vec import Vec3  # noqa: E402

# each cell at a size a test run holds: the lampshade to 12x12 pixels for
# its passes, to 10x8 pixels, 3,000 photons and 2 samples for its renders;
# the pegasus to 2,000 of its triangles (`linspace` rows), 16x16 pixels and
# 4 bounces
TINY = {"lampshade.pathtrace": {"width": 12, "height": 12},
        "lampshade.beamphoton": {"width": 10, "height": 8,
                                 "settings": {"beamphoton": {"photons": 3000, "samples": 2}}},
        "pegasus.passes": {"width": 16, "height": 16, "max_bounces": 4,
                           "mesh": {"triangles": 2000}}}
CELLS = sorted(TINY)
# the dragon's configuration (its cell waits for a program fix, PERF.md):
# the stand-in cut to 1,152 triangles and 24x16 pixels
DRAGON = {"width": 24, "height": 16, "mesh": {"n_u": 24, "n_v": 25}}


def _desc(name, seed):
    cell = spec.cell(spec.benchmark(), name)
    config = run._merge(cell["config"], TINY[name])
    params = cell["traffic"]
    settings = config["settings"][params["settings"]] if params.get("settings") else None
    return spec.module("scenes", cell["workload"]["config"]).describe(config, settings, seed), cell


def _renderer(config_name, desc, seed):
    """The port's renderer for ``desc``, built as `run.py` builds it."""
    return port_scene.builder(spec.module("scenes", config_name))(desc, seed, "cpu")


def _passes(renderer, desc, seed, n):
    """The program's samples of ``n`` one-sample passes, and their lanes."""
    w, h = renderer.width_, renderer.height_
    buffer = rpt.Buffer(w, h)
    values = []
    for _ in range(n):
        before = buffer.sum.copy()
        renderer.sample(1, buffer)
        values.append((buffer.sum - before).reshape(-1, 3))
    return np.concatenate(values), np.tile(np.arange(w * h), n), np.repeat(np.arange(n), w * h)


def _run(name, capsys, seed=2_147_483_659, seconds=1.0):
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "0"], device="cpu", overrides=TINY[name])
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "check"
    assert [line.split()[1] for line in err.strip().splitlines()[-3:]] == [
        "mismatch_share", "failed", "non_finite_pixels"]
    return result


@pytest.mark.parametrize("name", ["dragon", "lampshade.pathtrace", "pegasus.passes"])
def test_path_reference_matches_the_ports_cpu_path(name):
    seed = 5_000_000_017
    if name == "dragon":
        config = run._merge(spec.load_json(CHECKOUT, "perfbench", "configs", "dragon.json"), DRAGON)
        desc = spec.module("scenes", "dragon").describe(config, None, seed)
        config_name, radiance = "dragon", ref.radiance
    else:
        desc, cell = _desc(name, seed)
        config_name = cell["workload"]["config"]
        radiance = spec.module("reference", cell["check"]["reference"]).radiance
    renderer = _renderer(config_name, desc, seed)
    program, pixels, samples = _passes(renderer, desc, seed, 3)
    reference = radiance(desc, seed, pixels, samples, "cpu")
    lit = (reference != 0).any(-1)
    assert lit.mean() > 0.05
    np.testing.assert_allclose(program, reference, rtol=1e-5, atol=1e-7)


def test_photon_reference_matches_the_ports_cpu_path():
    seed = 5_000_000_017
    desc, _ = _desc("lampshade.beamphoton", seed)
    renderer = _renderer("lampshade", desc, seed)
    renders = spec.module("traffic", "renders")
    renders._configure(renderer, desc["render"])
    renders._render(renderer, desc["render"])
    program = renderer._last_buffer.sum.reshape(-1, 3)
    n_pix = desc["width"] * desc["height"]
    reference = ref_photon.render_pixels(desc, seed, np.arange(n_pix), "cpu")
    assert (reference != 0).any(-1).all()
    np.testing.assert_allclose(program, reference, rtol=1e-5, atol=1e-12)
    sc = ref_photon.RefScene(desc, "cpu")
    surface, volume = ref_photon.shoot(sc, ref_photon.rng.fold_in(ref_photon.rng.key(seed), 1),
                                       3000, desc["render"]["watts"] * 3000)
    assert renderer.photon_counts == {"surface": surface.shape[0], "volume": volume.shape[0],
                                      "dropped": 0}


def test_knn_is_exact_on_a_dense_body_in_a_wide_halo():
    g = torch.Generator().manual_seed(3)
    points = torch.cat([torch.randn(4000, 3, generator=g) * 20 + 200,
                        torch.randn(400, 3, generator=g) * 3000,
                        torch.randn(800, 3, generator=g) * 0.5 + 150]).float()
    queries = torch.cat([points[::13], torch.rand(300, 3, generator=g) * 400])
    idx, d2 = ref_photon.knn(points, queries, 10)
    diff = [points[None, :, i] - queries[:, None, i] for i in range(3)]
    dist = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    vals, _ = torch.topk(dist, 10, largest=False, sorted=True)
    assert torch.equal(d2, vals)
    assert torch.equal(dist.gather(1, idx), vals)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, capsys):
    result = _run(name, capsys)
    assert result["correct"] is True
    assert result["check"]["mismatch_share"]["value"] == 0.0
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.cell(
        spec.benchmark(), name)["end_to_end"]}


def _unchanged_state(monkeypatch):
    def sample(self, iterations, buffer):  # the pass runs, the buffer is not touched
        self._sample_index += iterations

    original = rpt.Renderer.photon_render

    def photon_render(self, photon_count, kind, occlusion_check=True):
        if getattr(self, "_last_buffer", None) is None:  # the warm-up renders
            return original(self, photon_count, kind, occlusion_check)
        return None  # a render of the window returns, the image stays the last one

    monkeypatch.setattr(rpt.Renderer, "sample", sample)
    monkeypatch.setattr(rpt.Renderer, "photon_render", photon_render)


def _broken_estimates(monkeypatch, edit):
    """``edit`` applied to each lane's radiance where it is produced: the
    path tracer's wavefronts and the photon camera pass's estimates."""
    for fn_name in ("trace_surface", "trace_volumetric"):
        original = getattr(port_path, fn_name)

        def broken(*args, _original=original, **kwargs):
            color, segments = _original(*args, **kwargs)
            return Vec3(*(edit(c) for c in (color.x, color.y, color.z))), segments

        monkeypatch.setattr(port_path, fn_name, broken)
    original = port_photon.estimate_indirect

    def broken_estimate(*args, **kwargs):
        color = original(*args, **kwargs)
        return Vec3(*(edit(c) for c in (color.x, color.y, color.z)))

    monkeypatch.setattr(port_photon, "estimate_indirect", broken_estimate)


def _half_the_batch(monkeypatch):
    def edit(c):  # odd lanes left out, the mean taken over the even ones
        keep = (torch.arange(c.shape[0]) % 2 == 0).to(c.dtype)
        return c * keep * 2.0

    _broken_estimates(monkeypatch, edit)


def _answer_altered(monkeypatch):
    _broken_estimates(monkeypatch, lambda c: c * 1.01)


def _non_finite_pixel(monkeypatch):
    def edit(c):  # one lane's answer turned NaN
        c = c.clone()
        c[min(3, c.shape[0] - 1)] = float("nan")
        return c

    _broken_estimates(monkeypatch, edit)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_batch, _answer_altered],
                         ids=["state_unchanged", "half_the_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(name, fault, capsys, monkeypatch):
    fault(monkeypatch)
    result = _run(name, capsys)
    assert result["correct"] is False
    assert result["check"]["mismatch_share"]["value"] > spec.cell(
        spec.benchmark(), name)["check"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_non_finite_pixel_is_not_correct(name, capsys, monkeypatch):
    _non_finite_pixel(monkeypatch)
    result = _run(name, capsys)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert result["check"]["non_finite_pixels"]["value"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_fails_the_limit(name):
    seed = 7_000_000_001
    desc, cell = _desc(name, seed)
    loop = spec.module("traffic", cell["traffic"]["loop"])
    reference = spec.module("reference", cell["check"]["reference"])
    n_pix = desc["width"] * desc["height"]
    if cell["traffic"]["loop"] == "passes":
        lanes = (np.tile(np.arange(n_pix), 2), np.repeat(np.arange(1, 3), n_pix))
    else:
        lanes = [(seed, np.arange(n_pix))]
    expected = loop.recompute(reference, desc, seed, lanes, "cpu", torch.float32)
    control = loop.recompute(reference, desc, seed, lanes, "cpu", torch.bfloat16)
    chk = cell["check"]
    assert check.mismatch_share(control, expected, chk["rtol"], chk["atol"]) > 3 * chk["limit"]


def test_pairs_are_each_pass_of_each_watched_pixel():
    watched = np.cumsum(np.arange(24, dtype=np.float64).reshape(4, 2, 3), axis=0)
    watched = np.concatenate([np.zeros((1, 2, 3)), watched])
    pixels, samples, values = check.pairs(watched, np.array([5, 9]), 1, seed=3, cap=100)
    assert pixels.tolist() == [5, 9] * 4
    assert samples.tolist() == [1, 1, 2, 2, 3, 3, 4, 4]
    np.testing.assert_array_equal(values, np.arange(24).reshape(8, 3))
    pixels, samples, values = check.pairs(watched, np.array([5, 9]), 1, seed=3, cap=5)
    assert len(pixels) == 5


def test_mismatch_share_leaves_out_black_samples_and_counts_non_finite():
    ref_v = np.array([[0.0, 0, 0], [1, 1, 1], [2, 2, 2], [3, 3, 3]])
    prog = np.array([[0.0, 0, 0], [1, 1, 1.01], [2, 2, 2], [np.nan, 3, 3]])
    assert check.mismatch_share(prog, ref_v, 1e-3, 1e-6) == pytest.approx(2 / 3)
