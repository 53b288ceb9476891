"""The port's ODE module against `rpt_tpu.ode` on the CPU:
`tests/test_ode.py`'s four cases on both packages, a 50-step
`MarblesSystem` run from the same packed state, and one frame of the
marbles example (`examples/torch_marbles.py` against the scene of
`examples/marbles.py`: the monomial glass, 25 spheres, the sphere light
and the procedural sky) through the path tracer.

Tolerances, and why:
- the circle: the reference's own (|p - p_expected| < 1e-3), and the two
  packages within 1e-5 (the same float32 operations, summed in another
  order over 1,257 RK4 steps);
- forces (one derivative): rtol 1e-5, atol 1e-6 of the largest value
  (gravity), rtol 1e-4 and atol 2e-5 of the largest value (marbles: a
  marble pressed into the glass takes its push along cvec / |cvec| from
  the closest point, which amplifies an ulp; measured 1.07e-3 on a
  component of 9.7, 1.1e-5 of the largest value, 95.7); powers round as XLA's
  ``integer_pow`` does (`ode._ipow`), but ``hypot`` and ``sqrt`` may differ
  by an ulp;
- closest points: the sample grid of ``torch.linspace`` differs from
  XLA's folded ``jnp.linspace`` by an ulp at some samples, so a near-tie
  may pick a neighbouring sample: with 201 samples every point within
  one grid step (0.03) and >= 99% within 1e-5 (measured: all within
  1.8e-6); with 20001 (step 1e-4, where d^2 is flat about its minimum)
  every point within 1e-3 and >= 90% within 1e-5 (measured: 5.3e-4, 95.9%);
- the 50-step marbles run (10 marbles touch the glass, 67 pairs touch):
  rtol 1e-4, atol 1e-5 (measured: 2.6e-5 relative, 4.5e-5 absolute on
  velocities of up to 2.3);
- the marbles frame: `tests/test_torch_path.py`'s render limits,
  per-pixel mean |diff| / mean <= 0.5% and image means within 0.5%.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu as jr
from rpt_tpu import ode as jode
from rpt_tpu.renderer import build_launch
from rpt_tpu.vec import Vec3 as JVec3
import rpt_tpu_torch as tr
from rpt_tpu_torch import ode as tode
from rpt_tpu_torch import renderer as trenderer
from rpt_tpu_torch.vec import Vec3 as TVec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import _assets  # noqa: E402
import torch_marbles  # noqa: E402

R = 0.15


def _both(pos, vel):
    return jode.ParticleState.of(pos, vel), tr.ParticleState.of(pos, vel, "cpu")


def _close(t, j, rtol, atol):
    for name in ("pos", "vel"):
        a, b = getattr(j, name).to_numpy(), getattr(t, name).to_numpy()
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol * max(np.abs(a).max(), 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("time,expected", [(2.0 * math.pi, 1.0), (math.pi, -1.0)],
                         ids=["full", "half"])
def test_rk4_circle_matches(time, expected):
    j, t = _both([[1.0, 0.0, 0.0]], [[0.0, 0.0, 0.0]])
    jo = jode.SimpleCircleSystem().rk4_integrate(j, time, 0.005)
    to = tr.SimpleCircleSystem().rk4_integrate(t, time, 0.005)
    assert isinstance(to, tr.ParticleState) and to.pos.x.dtype == torch.float32
    assert np.linalg.norm(to.pos.to_numpy()[0] - [expected, 0.0, 0.0]) < 1e-3
    np.testing.assert_allclose(to.pos.to_numpy(), jo.pos.to_numpy(), atol=1e-5)


def test_monomial_closest_point_matches():
    """Points on the surface map near themselves, the origin to itself
    (`tests/test_ode.py`), and 512 random points as in the JAX package."""
    on = [(0.0, 1.0), (0.0, -1.0), (0.23234, 0.723423), (0.12323, -0.23423)]
    pts = np.array([[x, (x**2 + z**2) ** 2, z] for x, z in on])
    cp = tode.monomial_closest_point(1.0, TVec3.from_array(pts)).to_numpy()
    assert (np.linalg.norm(cp - pts, axis=1) < 0.03).all()
    origin = tode.monomial_closest_point(1.0, TVec3.from_array(np.zeros((1, 3)))).to_numpy()
    assert np.allclose(origin, 0.0)

    rng = np.random.default_rng(0)
    pts = rng.uniform([-1.2, -0.2, -1.2], [1.2, 2.5, 1.2], (512, 3))
    a = jode.monomial_closest_point(2.0, JVec3.from_array(pts)).to_numpy()
    b = tode.monomial_closest_point(2.0, TVec3.from_array(pts)).to_numpy()
    err = np.abs(a - b).max(axis=1)
    assert (err < 0.03).all() and (err < 1e-5).mean() >= 0.99
    a = jode.monomial_closest_point_precise(2.0, JVec3.from_array(pts)).to_numpy()
    b = tode.monomial_closest_point_precise(2.0, TVec3.from_array(pts)).to_numpy()
    err = np.abs(a - b).max(axis=1)
    assert (err < 1e-3).all() and (err < 1e-5).mean() >= 0.9


def test_gravity_matches():
    """Two particles: equal, opposite, attracting (`tests/test_ode.py`);
    eight random ones against the JAX system."""
    j, t = _both([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]], np.zeros((2, 3)))
    acc = tr.SolidGravitySystem().time_derivative(t).vel.to_numpy()
    assert np.allclose(acc[0], -acc[1], atol=1e-6) and acc[0][0] > 0
    rng = np.random.default_rng(2)
    j, t = _both(rng.uniform(-1.0, 1.0, (8, 3)), rng.normal(size=(8, 3)))
    _close(tr.SolidGravitySystem().time_derivative(t),
           jode.SolidGravitySystem().time_derivative(j), 1e-5, 1e-6)


def _packed_marbles():
    """25 marbles packed on the glass's bottom, moving (seed 5)."""
    pos = np.array([[(i // 5) / 5.0 - 0.375, 0.25 + 0.05 * (i % 3), (i % 5) / 5.0 - 0.375]
                    for i in range(25)])
    return pos, np.random.default_rng(5).normal(0.0, 0.3, (25, 3))


def test_marbles_derivative_matches():
    """A marble resting just below table height is pushed up
    (`tests/test_ode.py`); the packed state's derivative as the JAX one."""
    j, t = _both([[3.0, 0.3 - 0.07, 0.0]], [[0.0, 0.0, 0.0]])
    assert tr.MarblesSystem(0.3).time_derivative(t).vel.to_numpy()[0][1] > 0.0
    j, t = _both(*_packed_marbles())
    _close(tr.MarblesSystem(R).time_derivative(t), jode.MarblesSystem(R).time_derivative(j),
           1e-4, 2e-5)


def test_marbles_run_matches():
    """50 RK4 steps of 1e-3 s from the packed state (10 marbles touch the
    glass, 67 pairs each other)."""
    j, t = _both(*_packed_marbles())
    jo = jode.MarblesSystem(R).rk4_integrate(j, 50 * 1e-3, 1e-3)
    to = tr.MarblesSystem(R).rk4_integrate(t, 50 * 1e-3, 1e-3)
    assert np.abs(to.pos.to_numpy() - t.pos.to_numpy()).max() > 0.01
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(to, name).to_numpy(), getattr(jo, name).to_numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _jax_marbles_scene(positions):
    """`examples/marbles.py:36-75` with the JAX package."""
    scene = jr.Scene()
    scene.add(_assets.get_hdri("ballroom_8k"))
    scene.add(jr.Light.Object(
        jr.Object(jr.sphere().scale((1.5, 1.5, 1.5)).translate((0.0, 5.0, 0.0))).material(
            jr.Material.light(jr.hex_color(0xFFFFFF), 15.0))))
    scene.add(jr.Object(jr.monomial_surface(2.0)).material(jr.Material.clear(1.5, 0.0001)))
    colors = torch_marbles.COLORS
    for i, p in enumerate(positions):
        scene.add(jr.Object(jr.sphere().scale((R, R, R)).translate(tuple(p))).material(
            jr.Material.specular(jr.hex_color(colors[i % len(colors)]), 0.1)))
    scene.add(jr.Object(jr.polygon(
        [(20.0, -0.06, 20.0), (20.0, -0.06, -20.0), (-20.0, -0.06, -20.0), (-20.0, -0.06, 20.0)]
    )).material(jr.Material.diffuse(jr.hex_color(0xAAAAAA))))
    return scene


def test_marbles_frame_matches_jax():
    """A 32x24 frame, 2 spp, 3 bounces, seed 0, with the marbles packed in
    the glass: the port's per-sample launch against `build_launch` on the
    same keys. Every ray meets the monomial glass's bounding box, and
    misses read the sky."""
    width, height, spp, bounces = 32, 24, 2, 3
    positions = _packed_marbles()[0]
    jc = _jax_marbles_scene(positions).compile()
    jcam = jr.Camera.look_at((0.0, 1.0, 6.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0),
                             math.pi / 4).focus((0.0, 1.0, 0.0), 0.02)
    fn = jax.jit(build_launch(jc, jcam, width, height, bounces, 32, spp))
    ref = np.asarray(fn(jc.tables, jax.random.key(0), jnp.int32(0))).astype(np.float64)

    r = torch_marbles.renderer("cpu", positions, width=width, height=height, sample=spp)
    tc = r.compiled
    assert (tc.n_spheres, tc.n_monomials, tc.n_tris) == (jc.n_spheres, jc.n_monomials, jc.n_tris)
    assert isinstance(tc.environment, tr.Hdri)
    got, segments = trenderer._path_pass(tc, r.camera, width, height, tr.sampling.key(0), 0, spp,
                                         bounces)
    assert np.isfinite(got).all() and got.mean() > 0 and segments > width * height * spp
    scale = ref.mean()
    assert np.abs(got - ref).mean() / scale <= 0.005
    assert abs(got.mean() / scale - 1.0) <= 0.005
