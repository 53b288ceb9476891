"""The media branch of the port against `rpt_tpu` on the CPU: the
Henyey-Greenstein medium, `sample_lights_for_media`, `trace_volumetric`
lane for lane, the volumetric `Renderer.render`, and its golden.

Inputs come from numpy seeds; both packages get the same rays and, through
the bit-exact threefry, the same keys.

Tolerances, and why:
- `phase` / `sample_ph`: the same f32 formulas; XLA and torch differ in
  how they evaluate ``x ** 1.5``, ``cos`` and ``rsqrt``: rtol 2e-5, and
  atol 2e-6 for direction components near 0.
- `sample_lights_for_media`: a shadow ray grazing an edge may flip between
  the packages: rtol 1e-4 (atol 1e-6 of the largest value) on >= 99.5% of
  lanes.
- `trace_volumetric`: paths in a medium diverge. A last-bit difference
  between the free-flight distance and the hit distance, or a grazing
  shadow ray, flips a lane's event and everything after it. So a lane
  agrees when its radiance is within rtol 1e-3 (atol 1e-4 of the mean
  radiance); >= 99% of lanes must agree, and the mean radiance of the
  wavefront must agree within 1%.
- renders: per-pixel mean |diff| / image mean <= 1% and image means within
  1%, as for `trace_surface` with the divergence above.
- the golden: `tests/test_golden.py::_check(tol_mean=0.03, tol_p99=0.25)`,
  with no floor.
"""

import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

import rpt_tpu as jr
from rpt_tpu import sampling as js
from rpt_tpu.integrators import path as jpath
from rpt_tpu.meshes import displaced_blob as jax_displaced_blob
from rpt_tpu.ray import Ray as JRay
from rpt_tpu.vec import Vec3 as JVec3
import rpt_tpu_torch as tr
from rpt_tpu_torch import intersect as tint
from rpt_tpu_torch import sampling as ts
from rpt_tpu_torch.integrators import path as tpath
from rpt_tpu_torch.ray import Ray as TRay
from rpt_tpu_torch.vec import Vec3 as TVec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import _lampshade  # noqa: E402
import torch_dragon  # noqa: E402
import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402
import torch_volumetric_pathtrace_lampshade as tvol  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
WATTS = 200_000.0 / (130.0 * 105.0)


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("g", [0.0, 0.6, -0.4])
def test_henyey_greenstein_matches_jax(g):
    """`phase` on random direction pairs and `sample_ph` under the same
    keys, for the isotropic branch (g = 0) and both signs of g."""
    n = 1024
    rng = np.random.default_rng(5)
    wo, wi = _unit(rng, n), _unit(rng, n)
    jm = jr.Medium.henyey_greenstein(1e-4, 1e-3, g)
    tm = tr.Medium.henyey_greenstein(1e-4, 1e-3, g)
    assert jm.phase_const is None and tm.phase_const is None
    j_ph = np.asarray(jm.phase(JVec3.from_array(wo), JVec3.from_array(wi)))
    t_ph = tm.phase(TVec3.from_array(wo), TVec3.from_array(wi)).numpy()
    np.testing.assert_allclose(t_ph, j_ph, rtol=2e-5)
    assert t_ph.min() > 0 and (g == 0.0 or t_ph.max() / t_ph.min() > 2)

    j_wi, j_pdf = jm.sample_ph(JVec3.from_array(wo), js.keys_for(jax.random.key(9), n))
    t_wi, t_pdf = tm.sample_ph(TVec3.from_array(wo), ts.keys_for(ts.key(9), n))
    np.testing.assert_allclose(t_wi.to_numpy(), j_wi.to_numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(t_pdf.numpy(), np.asarray(j_pdf), rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(t_wi.to_numpy(), axis=1), 1.0, atol=1e-5)
    # the tan colour and the homogeneous coefficients
    p = rng.uniform(0, 500, (4, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.color(TVec3.from_array(p)).to_numpy(),
                               jm.color(JVec3.from_array(p)).to_numpy(), rtol=1e-6)
    assert float(tm.extinction(TVec3.from_array(p))[0]) == pytest.approx(1.1e-3, rel=1e-6)


# ---------------------------------------------------------------------------
# scenes, built the same way in both packages


def _lampshade_pair(medium):
    """The lampshade scene with ``medium(rpt)`` added, compiled by both
    packages: (jax compiled scene, torch compiled scene)."""
    js_ = _lampshade.build_scene(jr.Material.light(jr.hex_color(0xFFFEFA), WATTS))
    js_.add(medium(jr))
    ts_ = tlamp.build_scene(tr.Material.light(tr.hex_color(0xFFFEFA), WATTS))
    ts_.add(medium(tr))
    return js_.compile(), ts_.compile("cpu")


def _foggy_mesh_pair(medium):
    """The bench scene (`bench.py:94-122`) with a 288-triangle blob, whose
    BVH has more than 8 leaf rows (the plain `_traverse` route in both
    packages), in fog."""
    mesh = (12, 13)
    js_ = jr.Scene()
    js_.add(jr.Object(jax_displaced_blob(*mesh).scale((3.4, 3.4, 3.4)).rotate_y(math.pi / 2))
            .material(jr.Material.specular(jr.hex_color(0xB7CA79), 0.1)))
    js_.add(jr.Object(jr.plane((0.0, 1.0, 0.0), -1.0)).material(
        jr.Material.diffuse(jr.hex_color(0xAAAAAA))))
    js_.add(jr.Light.Ambient((0.01, 0.01, 0.01)))
    js_.add(jr.Light.Object(
        jr.Object(jr.sphere().scale((2.0, 2.0, 2.0)).translate((0.0, 20.0, 3.0))).material(
            jr.Material.light((1.0, 1.0, 1.0), 160.0))))
    js_.add(jr.Light.Object(
        jr.Object(jr.sphere().scale((0.05, 0.05, 0.05)).translate((-1.0, 0.71, 0.0))).material(
            jr.Material.light(jr.hex_color(0xFFAAAA), 400.0))))
    js_.add(medium(jr))
    ts_ = torch_dragon.build_scene(*mesh)
    ts_.add(medium(tr))
    jc, tc = js_.compile(), ts_.compile("cpu")
    assert tc.n_tris == jc.n_tris and tc.tables["bvh"].leaves.shape[0] > tint.DENSE_TRI_ROWS
    return jc, tc


def _rays(eye, lo, hi, n, seed):
    """``n`` rays from ``eye`` towards uniform points of the box [lo, hi]."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(lo, hi, (n, 3))
    d = target - np.asarray(eye)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.tile(np.asarray(eye, np.float32), (n, 1)), d.astype(np.float32)


CASES = {
    "lampshade": (lambda: _lampshade_pair(lambda m: m.Medium.homogeneous_isotropic(1e-4, 1e-3)),
                  (278.0, 273.0, -800.0), (0, 0, 0), (556, 548, 559)),
    "glowing_fog": (lambda: _lampshade_pair(lambda m: m.Medium.colored_glowing_fog(1e-4, 2e-3)),
                    (278.0, 273.0, -800.0), (0, 0, 0), (556, 548, 559)),
    "henyey_greenstein": (lambda: _lampshade_pair(
        lambda m: m.Medium.henyey_greenstein(1e-4, 3e-3, 0.6)),
        (278.0, 273.0, -800.0), (0, 0, 0), (556, 548, 559)),
    "foggy_mesh": (lambda: _foggy_mesh_pair(lambda m: m.Medium.homogeneous_isotropic(0.01, 0.1)),
                   (-2.5, 4.0, 6.5), (-3, -1, -3), (3, 3, 3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_volumetric_matches_jax(case):
    """512 lanes, 8 levels, the same rays and keys: per-lane radiance
    (module docstring), the traced segment count within 1%, and for the
    glowing fog emission at level 0 only, in a position-dependent colour."""
    build, eye, lo, hi = CASES[case]
    jc, tc = build()
    n, depth = 512, 8
    o, d = _rays(eye, lo, hi, n, seed=11)
    ref, j_seg = jpath.trace_volumetric(
        jc, jc.tables, JRay(JVec3.from_array(o), JVec3.from_array(d)),
        js.keys_for(jax.random.key(4), n), depth, return_stats=True)
    got, t_seg = tpath.trace_volumetric(
        tc, tc.tables, TRay(TVec3.from_array(o), TVec3.from_array(d)),
        ts.keys_for(ts.key(4), n), depth, return_stats=True)
    ref, got = ref.to_numpy().astype(np.float64), got.to_numpy().astype(np.float64)
    assert np.isfinite(got).all() and got.mean() > 0
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-4 * ref.mean()).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() / ref.mean() - 1.0) <= 0.01
    assert abs(int(t_seg) / int(j_seg) - 1.0) <= 0.01 and int(t_seg) > n
    if case == "glowing_fog":
        # red above y = 250 and blue below: both channels carry emission
        assert got[:, 0].mean() > 0.5 and got[:, 2].mean() > 0.5


def test_sample_lights_for_media_matches_jax():
    """NEE at 1024 random points of the lampshade's medium (HG, so the
    phase depends on the directions), every fourth lane masked off (its
    result is the unshadowed contribution, which the caller discards)."""
    jc, tc = _lampshade_pair(lambda m: m.Medium.henyey_greenstein(1e-4, 1e-3, 0.6))
    n = 1024
    rng = np.random.default_rng(2)
    pos = rng.uniform((5, 5, 5), (550, 540, 550), (n, 3)).astype(np.float32)
    wo = _unit(rng, n)
    mask = np.ones(n, bool)
    mask[::4] = False
    ref = jpath.sample_lights_for_media(
        jc, jc.tables, jc.media[0], JVec3.from_array(pos), JVec3.from_array(wo),
        js.keys_for(jax.random.key(6), n), mask=jax.numpy.asarray(mask)).to_numpy()
    got = tpath.sample_lights_for_media(
        tc, tc.tables, tc.media[0], TVec3.from_array(pos), TVec3.from_array(wo),
        ts.keys_for(ts.key(6), n), mask=torch.tensor(mask)).to_numpy()
    # a masked lane's shadow ray is not traced (limit -1), so it counts as lit
    assert (got[~mask] > 0).any(axis=1).all()
    lit = (got[mask] > 0).any(axis=1).mean()
    assert 0.05 < lit < 0.95  # the shades hide the light from part of the box
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-6 * ref.max()).all(axis=1)
    assert close.mean() >= 0.995, close.mean()


def test_volumetric_pure_scattering_conserves():
    """The port's counterpart of `tests/test_integrator.py::
    test_volumetric_pure_scattering_conserves`: a white pure-scattering
    medium in a unit environment is unbiased, so the mean radiance is the
    environment's up to Monte Carlo noise and the depth cap (within 0.05)."""
    scene = tr.Scene()
    scene.add(tr.Object(tr.sphere().translate((0.0, 0.0, 10000.0))).material(
        tr.Material.diffuse((0.0, 0.0, 0.0))))
    scene.add(tr.ColorEnvironment((1.0, 1.0, 1.0)))
    scene.add(tr.Medium.henyey_greenstein(0.0, 0.002, g=0.0, color=TVec3.of(1.0, 1.0, 1.0)))
    cs = scene.compile("cpu")
    n = 8192
    d = _unit(np.random.default_rng(0), n)
    ray = TRay(TVec3.from_array(np.zeros((n, 3), np.float32)), TVec3.from_array(d))
    out = tpath.trace_volumetric(cs, cs.tables, ray, ts.keys_for(ts.key(3), n), max_depth=48)
    assert abs(float(out.to_array().mean()) - 1.0) < 0.05


def _jax_renderer(size, spp, depth):
    scene = _lampshade.build_scene(jr.Material.light(jr.hex_color(0xFFFEFA), WATTS))
    scene.add(jr.Medium.homogeneous_isotropic(1e-4, 1e-3))
    return (jr.Renderer(scene, _lampshade.camera()).width(size).height(size).max_bounces(6)
            .seed(42).num_samples(spp).media_max_depth(depth))


def _port_renderer(size, spp, depth):
    return tlamp.renderer("cpu", size=size, bounce=6, sample=spp, photons=4000,
                          seed=42).media_max_depth(depth)


def test_render_matches_jax():
    """16x16, 4 spp, 8 levels, seed 42, through `Renderer.sample` of both
    packages (module docstring for the limits). The ray counter's segments
    are what was traced: more than the camera rays, at most every level
    with its shadow ray."""
    size, spp, depth = 16, 4, 8
    j = _jax_renderer(size, spp, depth)
    j_buf = jr.Buffer(size, size, j.filter_)
    j.sample(spp, j_buf)
    t = _port_renderer(size, spp, depth)
    img = t.render()
    ref, got = j_buf.raw(), t._last_buffer.raw()
    assert img.shape == (size, size, 3) and np.isfinite(got).all() and got.mean() > 0
    assert np.abs(got - ref).mean() / ref.mean() <= 0.01
    assert abs(got.mean() / ref.mean() - 1.0) <= 0.01
    paths = size * size * spp
    assert paths < t.ray_counter.segments <= paths * depth * 2


def test_render_meets_golden():
    """`tests/test_golden.py::test_golden_volumetric_pathtrace` for the
    port: 32x32, 6 spp, 8 levels, seed 42 under `_check(tol_mean=0.03,
    tol_p99=0.25)`."""
    r = _port_renderer(32, 6, 8)
    r.render()
    raw = r._last_buffer.raw()
    ref = np.load(os.path.join(GOLDEN_DIR, "lampshade_path_32_6spp.npy")).astype(np.float64)
    diff = np.abs(raw - ref)
    scale = max(ref.mean(), 1e-6)
    assert diff.mean() / scale < 0.03, diff.mean() / scale
    assert np.percentile(diff, 99) / scale < 0.25, np.percentile(diff, 99) / scale


def test_pathtrace_example_renderer():
    """The volumetric example's helper carries the JAX example's parameters."""
    r = tvol.renderer("cpu", size=8, sample=1)
    assert (tvol.absorb, tvol.scat, tvol.watts, tvol.sample, tvol.size) == (
        5e-5, 3e-3, 150.0, 1000, 128)
    assert r.media_max_depth_ == 32 and r.max_bounces_ == 10 and len(r.compiled.media) == 1
