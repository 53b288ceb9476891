"""The photon-map (point query) and beam-beam kinds of the port, and the
sphere sweep of a medium whose phase depends on the directions, against
`rpt_tpu` on the CPU and against the golden images.

Inputs come from numpy seeds or from the JAX package's own shoot (same
keys); where a test says "the JAX package's k-NN", the port's `knn_query`
is replaced by `rpt_tpu.accel.grid.knn_query` over the same points, since
that grid truncates a few percent of the gather lanes of a small cloud
where the port's k-NN is exact (`tests/test_torch_photon.py`).

Tolerances, and why:
- the thinning mask and the beams: the mask is drawn on the host from the
  row count alone, so the kept rows are equal; the beams' fields are the
  same f32 operations (rtol 1e-6).
- `volume_estimate_beams`: the port sums (lane, beam) pairs of a chunk in
  a matrix product, the JAX package beam after beam, and ``1 - cos^2``
  between a ray and a beam a few degrees apart amplifies a last-bit
  difference of the cosine (a contracted multiply-add) to 1e-4: rtol 1e-3
  (atol 1e-6 of the largest value) on >= 99.5% of lanes (a ray that passes
  a beam at its radius, or ends at it, may flip), means within 0.1%.
- `volume_estimate_point` with the JAX package's photons and k-NN: the
  same neighbours, summed in one order: rtol 1e-3 (atol 1e-6 of the mean).
  Without the occlusion recheck >= 99.5% of lanes (a free flight that ends
  within an ulp of the hit flips a lane between its volume and its surface
  term); with it >= 98%, since each surface lane traces 20 photon-to-point
  shadow rays and one grazing flip changes the lane (measured 98.6%, all
  of the others surface lanes).
- the sphere sweep with a Henyey-Greenstein phase: rtol 1e-3 (atol 1e-6 of
  the largest value) on >= 99.5% of lanes: the float32 cancellation of
  ``oc^2 - dd^2`` under another contraction, as for K-sweep (the isotropic
  medium shows the same 97% of lanes at 1e-4 and 100% at 1e-3).
- 16x16 renders: with the JAX package's k-NN, per-pixel mean |diff| <= 0.5%
  of the mean radiance and the means within 0.5%, point-beam's limits
  (measured: photon map 0.002%, beam-beam 0.44%). With the port's exact
  k-NN the photon-map kind keeps those limits (0.005%); the beam-beam kind
  is held to 2.5% per pixel and 1% in the mean (1.85% and 0.85%): its
  image is the darkest, almost all surface term, and at this size the JAX
  grid returns a non-exact 20-NN on 55 of the 241 gather lanes that hit
  (k-th distance^2 up to 1.89x the exact one).
- goldens: `tests/test_golden.py::_check_img`'s mean 0.02 and p99 0.2 of
  the golden's mean. `lampshade_photonmap_32` (mean 75 levels) gets no
  floor. `lampshade_beambeam_32` has a mean of 2.41 u8 levels, so its p99
  limit is 0.48 of a level and its mean limit 0.048 of a level: 148 of the
  3072 values one level off fail it. With the JAX package's photons and
  k-NN the port's map build and estimators meet the unmodified limits
  (`test_beam_estimates_meet_golden_given_reference_photons_and_knn`: 26
  values differ, mean 0.0035). The exact k-NN alone moves 182 values (mean
  0.028), the port's own photons alone 112 (0.015), both 260 (0.039): the
  golden encodes the JAX grid's truncated neighbour sets. So the port's
  own render is held to a p99 limit floored at one level and to a mean
  limit of 0.05, for this JAX-made golden only.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import rpt_tpu as jr
from rpt_tpu import sampling as js
from rpt_tpu.integrators import photon as jph
from rpt_tpu.intersect import closest_hit as jax_closest_hit
from rpt_tpu.ray import Ray as JRay
from rpt_tpu.vec import Vec3 as JVec3
import rpt_tpu_torch as tr
from rpt_tpu_torch import sampling as ts
from rpt_tpu_torch.integrators import photon as tph
from rpt_tpu_torch.intersect import closest_hit as port_closest_hit
from rpt_tpu_torch.ops.sphere_sweep import build_sphere_table, pack_spheres_transposed
from rpt_tpu_torch.ray import Ray as TRay
from rpt_tpu_torch.vec import Vec3 as TVec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import _lampshade  # noqa: E402
import torch_volumetric_beambeam_lampshade as tbeam  # noqa: E402
import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402
import torch_volumetric_photonphoton_lampshade as tpp  # noqa: E402
from test_torch_photon import _jax_grid_knn, _jax_shoot  # noqa: E402

WATTS = 200_000.0 / (130.0 * 105.0)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
EYE = (278.0, 273.0, -800.0)


def _scenes(medium=lambda m: m.Medium.homogeneous_isotropic(1e-4, 1e-3)):
    """The lampshade scene with a medium, compiled by both packages."""
    j = _lampshade.build_scene(jr.Material.light(jr.hex_color(0xFFFEFA), WATTS))
    j.add(medium(jr))
    t = tlamp.build_scene(tr.Material.light(tr.hex_color(0xFFFEFA), WATTS))
    t.add(medium(tr))
    return j.compile(), t.compile("cpu")


def _rays(n, seed, away=64):
    """``n`` rays from the camera's eye into the box; the last ``away`` point
    away from the scene and hit nothing."""
    rng = np.random.default_rng(seed)
    d = rng.uniform((0, 0, 0), (556, 548, 559), (n, 3)) - np.asarray(EYE)
    d[n - away:, 2] *= -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = np.tile(np.asarray(EYE, np.float32), (n, 1)), d.astype(np.float32)
    return (JRay(JVec3.from_array(o), JVec3.from_array(d)),
            TRay(TVec3.from_array(o), TVec3.from_array(d)))


def _volume_rows(n, seed):
    """Synthetic volume photons in shoot order: deposits and beam starts
    uniform in the box, the direction from start to deposit, random power."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, tph.PHOTON_ROW), np.float32)
    rows[:, 0:3] = rng.uniform((0, 0, 0), (556, 548, 559), (n, 3))
    rows[:, 9:12] = rng.uniform((0, 0, 0), (556, 548, 559), (n, 3))
    seg = rows[:, 0:3] - rows[:, 9:12]
    rows[:, 3:6] = -seg / np.linalg.norm(seg, axis=1, keepdims=True)
    rows[:, 6:9] = rng.uniform(0.1, 1.0, (n, 3))
    return rows


def _share_close(got, ref, rtol, atol):
    return np.isclose(got, ref, rtol=rtol, atol=atol).all(axis=1).mean()


def _beam_maps(jc, tc, surface, volume, seed=42):
    j = jph.build_photon_map(jc, jc.tables, surface, volume, "beam_beam", 20, 3,
                             np.random.default_rng(seed + 17))
    t = tph.build_photon_map(tc, tc.tables, torch.tensor(surface), torch.tensor(volume),
                             tph.BEAM_BEAM, 20, 3, np.random.default_rng(seed + 17))
    return j, t


def test_beam_thinning_matches_jax():
    """200,000 synthetic volume rows: both packages keep the same ~200
    rows, in shoot order, as the same beams."""
    jc, tc = _scenes()
    volume = _volume_rows(200_000, seed=1)
    surface = _volume_rows(64, seed=2)
    j, t = _beam_maps(jc, tc, surface, volume)
    keep = np.random.default_rng(42 + 17).random(len(volume)) < tph.BEAM_THIN
    assert (tph.beam_keep_mask(np.random.default_rng(42 + 17), len(volume)) == keep).all()
    assert t.beams.n_beams == j.n_beams == keep.sum() and 150 < j.n_beams < 250
    np.testing.assert_array_equal(t.beams.start.numpy(), volume[keep][:, 9:12])
    for name in ("start", "dir", "power"):
        np.testing.assert_allclose(getattr(t.beams, name).numpy(),
                                   j.beams[name].to_numpy()[:j.n_beams], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.beams.length.numpy(), np.asarray(j.beams["length"]), rtol=1e-6)
    assert (t.beams.radius == 3.0).all()
    np.testing.assert_allclose(t.beams.power.numpy(), volume[keep][:, 6:9] * 1000.0, rtol=1e-6)


def test_volume_estimate_beams_matches_jax(monkeypatch):
    """1024 lanes x ~200 beams, in one chunk and in chunks of 64 beams;
    64 lanes miss everything. An empty volume cloud gives zero."""
    jc, tc = _scenes()
    volume = _volume_rows(200_000, seed=3)
    j, t = _beam_maps(jc, tc, _volume_rows(64, seed=2), volume)
    jray, tray = _rays(1024, seed=7)
    jhit = jax_closest_hit(jc, jc.tables, jray)
    thit = port_closest_hit(tc, tc.tables, tray)
    assert not bool(thit.valid[-64:].any()) and bool(thit.valid[:-64].all())
    ref = jph.volume_estimate_beams(j, jc.media[0], jray, jhit).to_numpy()
    got = tph.volume_estimate_beams(t, tc.media[0], tray, thit).to_numpy()
    assert np.isfinite(got).all() and (got > 0).any(axis=1).mean() > 0.3
    assert _share_close(got, ref, 1e-3, 1e-6 * ref.max()) >= 0.995
    assert abs(got.mean() / ref.mean() - 1.0) <= 1e-3
    monkeypatch.setattr(tph, "BEAM_PAIRS", 1024)  # 64 beams a chunk
    chunked = tph.volume_estimate_beams(t, tc.media[0], tray, thit).to_numpy()
    np.testing.assert_allclose(chunked, got, rtol=1e-3, atol=1e-6 * got.max())

    j0, t0 = _beam_maps(jc, tc, _volume_rows(64, seed=2), volume[:0])
    assert j0.n_beams == t0.beams.n_beams == 0
    assert (tph.volume_estimate_beams(t0, tc.media[0], tray, thit).to_numpy() == 0).all()
    assert (jph.volume_estimate_beams(j0, jc.media[0], jray, jhit).to_numpy() == 0).all()


def test_volume_estimate_point_matches_jax(monkeypatch):
    """The JAX package's 4000-photon shoot and its k-NN, 1024 lanes (64
    miss everything and take the volume term), gather 20 / 3. Then an
    empty volume cloud: the volume term is zero and lanes that hit keep
    their attenuated surface estimate."""
    surface, volume = _jax_shoot(4000)
    jc, tc = _scenes()
    monkeypatch.setattr(tph, "knn_query", _jax_grid_knn)
    jray, tray = _rays(1024, seed=8)
    jhit = jax_closest_hit(jc, jc.tables, jray)
    thit = port_closest_hit(tc, tc.tables, tray)
    jkeys, tkeys = js.keys_for(jax.random.key(5), 1024), ts.keys_for(ts.key(5), 1024)
    rng = np.random.default_rng(0)
    for vol, occlusion, share in ((volume, False, 0.995), (volume, True, 0.98),
                                  (volume[:0], False, 0.995)):
        j = jph.build_photon_map(jc, jc.tables, surface, vol, "photon_map", 20, 3, rng)
        t = tph.build_photon_map(tc, tc.tables, torch.tensor(surface), torch.tensor(vol),
                                 tph.PHOTON_MAP, 20, 3, rng)
        ref = jph.volume_estimate_point(jc, jc.tables, j, jc.media[0], jray, jhit, jkeys,
                                        20, 3, occlusion).to_numpy()
        got = tph.volume_estimate_point(tc, tc.tables, t, tc.media[0], tray, thit, tkeys,
                                        20, 3, occlusion).to_numpy()
        assert np.isfinite(got).all() and got.mean() > 0
        assert _share_close(got, ref, 1e-3, 1e-6 * ref.mean()) >= share
        assert abs(got.mean() / ref.mean() - 1.0) <= 0.01
        if len(vol) == 0:
            assert (got[-64:] == 0).all() and (ref[-64:] == 0).all()
        else:
            assert (got[-64:] > 0).any()


def test_sphere_sweep_with_directional_phase_matches_jax():
    """`volume_estimate_spheres` for a Henyey-Greenstein medium (g = 0.6)
    against the JAX package's XLA sweep, on the spheres of the JAX
    package's own point-beam map (1000 photons)."""
    hg = lambda m: m.Medium.henyey_greenstein(1e-4, 1e-3, 0.6)  # noqa: E731
    jc, tc = _scenes(hg)
    surface, volume = _jax_shoot(1000)
    j = jph.build_photon_map(jc, jc.tables, surface, volume, "point_beam", 20, 3,
                             np.random.default_rng(0))
    nv = j.n_spheres
    assert nv == len(volume) and tc.media[0].phase_const is None
    sph = pack_spheres_transposed(
        torch.tensor(np.asarray(j.spheres["pos4"])[:nv, :3]),
        torch.tensor(np.asarray(j.spheres["radius"])[:nv]),
        torch.tensor(j.spheres["dir"].to_numpy()[:nv]),
        torch.tensor(j.spheres["power"].to_numpy()[:nv]))
    t = tph.PhotonMapData(tph.POINT_BEAM, None, None, spheres=build_sphere_table(sph, nv))
    jray, tray = _rays(512, seed=9)
    jhit = jax_closest_hit(jc, jc.tables, jray)
    thit = port_closest_hit(tc, tc.tables, tray)
    ref = jph.volume_estimate_spheres(j, jc.media[0], jray, jhit).to_numpy()
    got = tph.volume_estimate_spheres(t, tc.media[0], tray, thit).to_numpy()
    assert np.isfinite(got).all() and (got > 0).any(axis=1).mean() > 0.5
    assert _share_close(got, ref, 1e-3, 1e-6 * ref.max()) >= 0.995
    # the phase matters: the isotropic medium's constant gives another answer
    _, iso_scene = _scenes()
    iso = tph.volume_estimate_spheres(t, iso_scene.media[0], tray, thit).to_numpy()
    assert abs(iso.mean() / got.mean() - 1.0) > 0.05


def _jax_renderer(size, photons, spp):
    scene = _lampshade.build_scene(jr.Material.light(jr.hex_color(0xFFFEFA), WATTS))
    scene.add(jr.Medium.homogeneous_isotropic(1e-4, 1e-3))
    return (jr.Renderer(scene, _lampshade.camera()).width(size).height(size).max_bounces(6)
            .seed(42).watts(WATTS * photons).num_samples(spp).gather_size(20)
            .gather_size_volume(3))


def _port_renderer(size, photons, spp):
    return tlamp.renderer("cpu", size=size, bounce=6, sample=spp, photons=photons, seed=42)


RENDERS = {"photon_map": "photon_map_render", "beam_beam": "photon_beam_query_beam_render"}


@pytest.mark.parametrize("kind", list(RENDERS))
def test_render_matches_jax(kind, monkeypatch):
    """16x16, 4000 photons, 1 spp, seed 42 through both renderers, the
    port's with its own exact k-NN and then with the JAX package's (module
    docstring for the limits)."""
    j = _jax_renderer(16, 4000, 1)
    getattr(j, RENDERS[kind])(4000)
    j_img = j._last_buffer.raw()
    own_limits = (0.025, 0.01) if kind == "beam_beam" else (0.005, 0.005)
    for jax_knn, (pixel_limit, mean_limit) in ((False, own_limits), (True, (0.005, 0.005))):
        if jax_knn:
            monkeypatch.setattr(tph, "knn_query", _jax_grid_knn)
        t = _port_renderer(16, 4000, 1)
        img = getattr(t, RENDERS[kind])(4000)
        t_img = t._last_buffer.raw()
        assert t.photon_map.kind == kind and img.shape == (16, 16, 3)
        assert np.isfinite(t_img).all() and t_img.mean() > 0
        assert np.abs(t_img - j_img).mean() / j_img.mean() <= pixel_limit
        assert abs(t_img.mean() - j_img.mean()) / j_img.mean() <= mean_limit


def _golden_errors(name, img):
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy")).astype(np.float64)
    diff = np.abs(np.asarray(img, np.float64) - ref)
    scale = max(ref.mean(), 1e-6)
    return diff.mean() / scale, np.percentile(diff, 99), scale


def test_photon_map_render_meets_golden():
    """`tests/test_golden.py:111-113` for the port, under `_check_img`'s
    unmodified limits."""
    img = _port_renderer(32, 4000, 2).photon_map_render(4000)
    mean_rel, p99, scale = _golden_errors("lampshade_photonmap_32", img)
    assert mean_rel < 0.02, mean_rel
    assert p99 < 0.2 * scale, p99 / scale


def test_beam_beam_render_meets_golden():
    """`tests/test_golden.py:121-123` for the port: mean |diff| < 0.05 x
    mean; p99 within 0.2 x mean floored at one u8 level (module docstring
    for both deviations from `_check_img`)."""
    img = _port_renderer(32, 4000, 2).photon_beam_query_beam_render(4000)
    mean_rel, p99, scale = _golden_errors("lampshade_beambeam_32", img)
    assert mean_rel < 0.05, mean_rel
    assert p99 <= max(0.2 * scale, 1.0), p99


def test_beam_estimates_meet_golden_given_reference_photons_and_knn(monkeypatch):
    """With the JAX package's photons and its grid k-NN, the port's beam
    map build (the thinning included) and estimators reproduce the
    beam-beam golden under `_check_img`'s unmodified limits."""
    j_surface, j_volume = _jax_shoot(4000)
    monkeypatch.setattr(tph, "knn_query", _jax_grid_knn)
    monkeypatch.setattr(tph, "shoot_photons_device", lambda *a, **k: tph.PhotonList(
        torch.tensor(j_surface), torch.tensor(j_volume), 0))
    t = _port_renderer(32, 4000, 2)
    img = t.photon_beam_query_beam_render(4000)
    assert 0 < t.photon_map.beams.n_beams < 30
    mean_rel, p99, scale = _golden_errors("lampshade_beambeam_32", img)
    assert mean_rel < 0.02, mean_rel
    assert p99 < 0.2 * scale, p99 / scale


def test_example_renderers_carry_the_jax_examples_parameters():
    """`examples/volumetric_photonphoton_lampshade.py` and
    `volumetric_beambeam_lampshade.py`: gather sizes, watts, medium."""
    r = tpp.renderer("cpu", size=8, sample=1)
    assert (r.gather_size_, r.gather_size_volume_, r.watts_, tpp.photons, tpp.sample) == (
        100, 30, 1e7, 1_000_000, 100)
    assert float(r.compiled.media[0].extinction(TVec3.zeros((1,)))[0]) == pytest.approx(1.6e-3)
    r = tbeam.renderer("cpu", size=8, sample=1)
    assert (r.gather_size_, r.gather_size_volume_, tbeam.photons, tbeam.sample) == (
        20, 3, 1_000_000, 50)
    assert r.watts_ == pytest.approx(WATTS * 1_000_000)
