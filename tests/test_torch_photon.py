"""The point-beam photon slice of the port end to end, against `rpt_tpu`
and the golden image: the shoot (same keys, same deposits), the render
at 16x16 (1000 photons, 1 spp, seed 42), and the 32x32 golden render.

Why the port's own golden render is held to a p99 limit floored at one
u8 level: the golden's mean is 4.97 levels, so `_check_img`'s 0.2 x mean
is 0.99 of a level, and more than 1% of the 3072 channel values one
level apart fail it (p99 / mean 0.2013 against 0.2). The golden was made
by the JAX package, whose grid k-NN truncates a few percent of gather
lanes; the port's k-NN is exact. With the JAX package's photons and
neighbour sets, the port's estimates meet the unmodified limits
(`test_estimates_meet_golden_given_reference_photons_and_knn`, 6 values
differ); with its own exact k-NN, 91 differ, and with the port's own
photons as well, 118. The floor is a deviation from `_check_img`, kept
by decision for this JAX-made golden only (PERF.md, findings)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rpt_tpu as jr
from rpt_tpu.accel.grid import build_photon_grid
from rpt_tpu.accel.grid import knn_query as jax_knn_query
from rpt_tpu.integrators import photon as jph
from rpt_tpu.vec import Vec3 as JVec3
from rpt_tpu_torch import sampling as ts
from rpt_tpu_torch.integrators import photon as tph

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import _lampshade  # noqa: E402
import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402

WATTS = 200_000.0 / (130.0 * 105.0)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "lampshade_pointbeam_32.npy")


def _jax_renderer(size, photons, spp):
    scene = _lampshade.build_scene(jr.Material.light(jr.hex_color(0xFFFEFA), WATTS))
    scene.add(jr.Medium.homogeneous_isotropic(1e-4, 1e-3))
    return (jr.Renderer(scene, _lampshade.camera()).width(size).height(size).max_bounces(6)
            .seed(42).watts(WATTS * photons).num_samples(spp).gather_size(20)
            .gather_size_volume(3))


def _port_renderer(size, photons, spp):
    return tlamp.renderer("cpu", size=size, bounce=6, sample=spp, photons=photons, seed=42)


def _jax_shoot(photons):
    jc = _jax_renderer(16, photons, 1).compiled
    s, s_n, v, v_n = jph.shoot_photons_device(
        jc, jc.tables, jax.random.fold_in(jax.random.key(42), 1), photons, WATTS * photons,
        "point_beam")
    return np.asarray(s)[:s_n], np.asarray(v)[:v_n]


def test_shoot_matches_jax():
    """Same keys, same deposit counts in the same order; rows within rtol
    1e-4 (atol 1e-4 in scene units of a 556-unit box) on >= 99.5% of rows:
    an f32 hit at a grazing edge may send one path its own way."""
    j_surface, j_volume = _jax_shoot(1000)
    tc = _port_renderer(16, 1000, 1).compiled
    photons = tph.shoot_photons_device(tc, tc.tables, ts.fold_in(ts.key(42), 1), 1000,
                                       WATTS * 1000)
    assert photons.dropped == 0
    for j_rows, t_rows in ((j_surface, photons.surface), (j_volume, photons.volume)):
        assert j_rows.shape == t_rows.shape and len(j_rows) > 1000
        close = np.isclose(t_rows.numpy(), j_rows, rtol=1e-4, atol=1e-4).all(axis=1)
        assert close.mean() >= 0.995, close.mean()


def test_render_matches_jax():
    """16x16, 1000 photons, 1 spp, seed 42: per-pixel mean |diff| within
    0.5% of the mean radiance, and the means within 0.5%. The port's exact
    k-NN against the JAX grid's truncating one gives 0.27% per pixel;
    with the JAX grid's neighbours it is 0.10%. A swapped channel order
    or a transposed image is off by more than 80%."""
    j = _jax_renderer(16, 1000, 1)
    j.photon_point_query_beam_render(1000)
    t = _port_renderer(16, 1000, 1)
    t.photon_point_query_beam_render(1000)
    j_img, t_img = j._last_buffer.raw(), t._last_buffer.raw()
    assert np.isfinite(t_img).all() and t_img.mean() > 0
    assert np.abs(t_img - j_img).mean() / j_img.mean() <= 0.005
    assert abs(t_img.mean() - j_img.mean()) / j_img.mean() <= 0.005


def _golden_errors(img):
    ref = np.load(GOLDEN).astype(np.float64)
    diff = np.abs(np.asarray(img, np.float64) - ref)
    scale = max(ref.mean(), 1e-6)
    return diff.mean() / scale, np.percentile(diff, 99), scale


def test_render_meets_golden():
    """`tests/test_golden.py:116-118`: mean |diff| < 0.02 x mean; p99 within
    0.2 x mean floored at one u8 level (module docstring)."""
    img = _port_renderer(32, 4000, 2).photon_point_query_beam_render(4000)
    mean_rel, p99, scale = _golden_errors(img)
    assert mean_rel < 0.02
    assert p99 <= max(0.2 * scale, 1.0)


def _jax_grid_knn(grid, queries, k):
    """The JAX package's grid k-NN over the port's grid-sorted points,
    returned in the port's index space."""
    pts = grid.points.numpy()
    static, tabs = build_photon_grid(pts, k=k)
    order = np.asarray(tabs["order"])
    pos4 = np.zeros((len(pts), 4), np.float32)
    pos4[:, :3] = pts[order]
    tabs = dict(tabs, pos4_2=jnp.asarray(pos4[np.asarray(tabs["map2"])]))
    q = queries.numpy()
    idx, d2, valid = jax_knn_query(static, tabs, jnp.asarray(pos4), JVec3.from_array(q), k)
    idx = order[np.minimum(np.asarray(idx), len(order) - 1)]
    return torch.tensor(idx), torch.tensor(np.asarray(d2)), torch.tensor(np.asarray(valid))


def test_estimates_meet_golden_given_reference_photons_and_knn(monkeypatch):
    """With the JAX package's photons and its grid k-NN, the port's map
    build and estimators reproduce the golden under `_check_img`'s
    unmodified limits (mean 0.02, p99 0.2 of the mean)."""
    j_surface, j_volume = _jax_shoot(4000)
    monkeypatch.setattr(tph, "knn_query", _jax_grid_knn)
    t = _port_renderer(32, 4000, 2)
    tc = t.compiled
    monkeypatch.setattr(tph, "shoot_photons_device", lambda *a, **k: tph.PhotonList(
        torch.tensor(j_surface), torch.tensor(j_volume), 0))
    img = t.photon_point_query_beam_render(4000)
    mean_rel, p99, scale = _golden_errors(img)
    assert tc.n_tris == 12
    assert mean_rel < 0.02
    assert p99 < 0.2 * scale
