"""Materials and lights of the port against `rpt_tpu`, lane for lane under
shared threefry keys (rtol 1e-5)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import rpt_tpu as jr
from rpt_tpu import lights as jl
from rpt_tpu import materials as jm
from rpt_tpu import sampling as js
from rpt_tpu.vec import Vec3 as JVec3
import rpt_tpu_torch as tr
from rpt_tpu_torch import lights as tl
from rpt_tpu_torch import materials as tm
from rpt_tpu_torch import sampling as ts
from rpt_tpu_torch.vec import Vec3 as TVec3

N = 2048
RTOL = 1e-5
ATOL = 1e-6


def _keys(seed):
    return js.keys_for(jax.random.key(seed), N), ts.keys_for(ts.key(seed), N)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _close(a, b, rtol=RTOL, atol=ATOL):
    a = a.to_numpy() if isinstance(a, JVec3) else np.asarray(a)
    b = b.to_numpy() if isinstance(b, TVec3) else b.numpy()
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _materials(pkg):
    return [
        pkg.Material.diffuse((0.8, 0.3, 0.1)),
        pkg.Material.specular((0.5, 0.6, 0.7), 20.0),
        pkg.Material.mirror(),
        pkg.Material.clear(1.5),
        pkg.Material.light((1.0, 0.9, 0.8), 12.0),
    ]


def test_sample_f_and_bsdf_agree():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 5, N).astype(np.int32)
    normal = _unit(rng, N)
    wo = _unit(rng, N)
    jt = jm.MaterialTable.build(_materials(jr)).lookup(jax.numpy.asarray(ids))
    tt = tm.MaterialTable.build(_materials(tr)).lookup(torch.tensor(ids))
    jk, tk = _keys(1)
    jn, tn = JVec3.from_array(normal), TVec3.from_array(normal)
    jwo, two = JVec3.from_array(wo), TVec3.from_array(wo)

    jwi, jpdf, jvalid = jm.sample_f(jt, jn, jwo, jk)
    twi, tpdf, tvalid = tm.sample_f(tt, tn, two, tk)
    assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
    _close(jwi, twi)
    _close(jpdf, tpdf)
    # every kind, and total internal reflection, occur
    assert set(ids) == {0, 1, 2, 3, 4} and not tvalid.all()

    wi = _unit(rng, N)
    _close(jm.bsdf(jt, jn, jwo, JVec3.from_array(wi)), tm.bsdf(tt, tn, two, TVec3.from_array(wi)))
    _close(jm.bsdf(jt, jn, jwo, jwi), tm.bsdf(tt, tn, two, twi))
    _close(jt.emittance_query(), tt.emittance_query())
    _close(jt.color_query(), tt.color_query())


def _area_lights(pkg):
    mat = pkg.Material.light((1.0, 0.8, 0.6), 25.0)
    tri = pkg.polygon([(0.0, 5.0, 0.0), (1.0, 5.0, 0.0), (1.0, 5.0, 1.0), (0.0, 5.0, 1.0)])
    return {
        "sphere": pkg.sphere().scale((0.5, 0.5, 0.5)).translate((0.0, 6.0, 1.0)),
        "cube": pkg.cube().scale((2.0, 0.3, 1.0)).rotate_y(0.4).translate((1.0, 7.0, -1.0)),
        "mesh": tri.translate((0.5, 0.0, 0.0)),
        "monomial": pkg.monomial_surface(0.5).scale((1.5, 1.0, 1.5)).translate((0.0, 8.0, 0.0)),
    }, mat


@pytest.mark.parametrize("kind", ["sphere", "cube", "mesh", "monomial"])
def test_sample_shape_and_illuminate_agree(kind):
    rng = np.random.default_rng(2)
    target = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    j_shapes, j_mat = _area_lights(jr)
    t_shapes, t_mat = _area_lights(tr)
    jstat, jtabs = jl.compile_light(jl.ObjectLight(j_shapes[kind], j_mat))
    tstat, ttabs = tl.compile_light(tl.ObjectLight(t_shapes[kind], t_mat))
    assert dataclasses.astuple(jstat) == dataclasses.astuple(tstat)
    jk, tk = _keys(3)
    jt, tt = JVec3.from_array(target), TVec3.from_array(target)
    for a, b in zip(jl.sample_shape(jstat, jtabs, jt, jk), tl.sample_shape(tstat, ttabs, tt, tk)):
        _close(a, b, atol=1e-5)
    for a, b in zip(jl.illuminate(jstat, jtabs, jt, jk), tl.illuminate(tstat, ttabs, tt, tk)):
        _close(a, b, atol=1e-5)


def test_point_and_directional_illuminate_agree():
    rng = np.random.default_rng(4)
    pos = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    jk, tk = _keys(5)
    for jlight, tlight in (
        (jr.Light.Point((1.0, 2.0, 3.0), (0.0, 9.0, 0.5)), tr.Light.Point((1.0, 2.0, 3.0), (0.0, 9.0, 0.5))),
        (jr.Light.Directional((0.5, 0.5, 0.5), (0.2, -1.0, 0.1)),
         tr.Light.Directional((0.5, 0.5, 0.5), (0.2, -1.0, 0.1))),
    ):
        jstat, jtabs = jl.compile_light(jlight)
        tstat, ttabs = tl.compile_light(tlight)
        j_out = jl.illuminate(jstat, jtabs, JVec3.from_array(pos), jk)
        t_out = tl.illuminate(tstat, ttabs, TVec3.from_array(pos), tk)
        for a, b in zip(j_out, t_out):
            _close(a, b)


@pytest.mark.parametrize("preset", ["homogeneous_isotropic", "colored_glowing_fog"])
def test_medium_agrees(preset):
    """Free-flight sampling, transmittance, phase sampling and the fields
    of both isotropic presets, lane for lane under shared keys."""
    from rpt_tpu.ray import Ray as JRay
    from rpt_tpu_torch.ray import Ray as TRay

    rng = np.random.default_rng(6)
    origin = rng.uniform(0.0, 500.0, (N, 3)).astype(np.float32)
    direction = _unit(rng, N)
    t_max = rng.uniform(0.0, 800.0, N).astype(np.float32)
    jmed = getattr(jr.Medium, preset)(1e-3, 4e-3)
    tmed = getattr(tr.Medium, preset)(1e-3, 4e-3)
    assert jmed.phase_const == tmed.phase_const
    jray = JRay(JVec3.from_array(origin), JVec3.from_array(direction))
    tray = TRay(TVec3.from_array(origin), TVec3.from_array(direction))
    jk, tk = _keys(7)
    for a, b in zip(jmed.sample_d(jray, jk), tmed.sample_d(tray, tk)):
        _close(a, b)
    _close(jmed.transmittence(jray, jax.numpy.asarray(t_max)),
           tmed.transmittence(tray, torch.tensor(t_max)))
    for a, b in zip(jmed.sample_ph(jray.dir, jk), tmed.sample_ph(tray.dir, tk)):
        _close(a, b)
    _close(jmed.phase(jray.dir, jray.dir), tmed.phase(tray.dir, tray.dir))
    for field in ("color", "emission", "absorption", "scattering", "extinction"):
        _close(getattr(jmed, field)(jray.origin), getattr(tmed, field)(tray.origin))
