"""The port's environments against `rpt_tpu.environment` on the CPU:
`ColorEnvironment`, and `Hdri.get_color` lane for lane on 4,096 random
directions of random lengths, the poles, the azimuth seam and the
clamped last column and row, on a 37 x 64 map the test makes (seed 0);
then `tests/test_environment.py`'s cases on the port, and an `Hdri` added
to a scene.

Tolerance: |diff| <= 4e-5 of the map's largest value. atan2, arccos and
rsqrt differ by a few ulp between XLA:CPU and CPU torch; the column x =
azimuth * (W - 1) / 2pi then moves by ~(W - 1) ulp(2pi) / 2pi ~ 5e-6 a ulp
at W = 64, and the bilinear lookup moves by that times a neighbour
difference, at most the map's largest value (measured: 1.5e-5). The
lookup is continuous across cells and at the clamped edges, so a lane
whose cell differs between the packages still agrees in value. The zero
direction is left out: XLA:CPU flushes `normalize`'s floor of 1e-38 (a
subnormal) to zero and returns NaN there, where the port returns a
finite value; no path traces a zero direction (dead lanes carry (0, 1, 0)).
"""

import math

import numpy as np
import pytest
import torch

import rpt_tpu as jr
from rpt_tpu.vec import Vec3 as JVec3
import rpt_tpu_torch as tr
from rpt_tpu_torch.vec import Vec3 as TVec3, lerp

H, W = 37, 64
TOL = 4e-5


def _map(seed=0):
    return np.random.default_rng(seed).uniform(0.0, 2.0, (H, W, 3))


def _directions():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(4096, 3)) * rng.uniform(0.01, 100.0, (4096, 1))
    tiny = 1e-8
    special = [
        (0.0, 1.0, 0.0), (0.0, -1.0, 0.0), (tiny, 1.0, 0.0), (0.0, -1.0, -tiny),  # poles
        (-1.0, 0.0, 0.0), (-1.0, 0.0, -0.0), (-1.0, 0.0, tiny), (-1.0, 0.0, -tiny),  # seam
        (-1.0, -1.0, -tiny), (-1.0, 1.0, tiny), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
        (0.0, 0.0, -1.0),
    ]
    return np.concatenate([d, np.array(special)])


def _both(buf, d):
    j, t = jr.Hdri(buf), tr.Hdri(buf)
    a = j.get_color(j.tables(), JVec3.from_array(d)).to_numpy()
    b = t.get_color(t.tables("cpu"), TVec3.from_array(d)).to_numpy()
    return a, b


def test_hdri_matches_jax_lane_for_lane():
    buf = _map()
    d = _directions()
    a, b = _both(buf, d)
    assert a.shape == b.shape == (len(d), 3) and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=0.0, atol=TOL * buf.max())
    # the seam: azimuth 2pi reads the last column, azimuth 0 the first
    last, first = buf[H // 2, W - 1], buf[H // 2, 0]
    assert np.allclose(b[4096 + 4], lerp_rows(buf, W - 1), atol=1e-5)
    assert np.allclose(b[4096 + 5], lerp_rows(buf, 0), atol=1e-5)
    assert not np.allclose(last, first)


def lerp_rows(buf, col):
    """The horizon direction's value in column ``col``: polar pi/2 falls
    halfway between rows (H - 1) / 2 floor and ceil."""
    y = math.acos(0.0) / math.pi * (H - 1)
    y0 = int(y)
    return buf[y0, col] + (buf[y0 + 1, col] - buf[y0, col]) * (y - y0)


def test_hdri_clamps_last_row_and_column():
    """A map whose last column and last row differ from the rest: the
    south pole reads the last row, and x0 + 1 past the last column is the
    last column itself (no wrap), in both packages."""
    buf = np.ones((H, W, 3))
    buf[:, -1] = 5.0
    buf[-1] = 9.0
    d = np.array([[0.0, -1.0, 0.0], [-1.0, -1e-3, 1e-7], [-1.0, 1e-3, 1e-7]])
    a, b = _both(buf, d)
    np.testing.assert_allclose(b, a, rtol=0.0, atol=TOL * buf.max())
    assert np.allclose(b[0], 9.0) and np.allclose(b[1:], 5.0, atol=1e-3)


def test_color_environment_and_jax_cases():
    """`tests/test_environment.py` on the port: a constant colour, the
    poles and the horizon of a polar ramp, and the azimuth ramp."""
    env = tr.ColorEnvironment((0.25, 0.5, 0.75))
    c = env.get_color(env.tables("cpu"), TVec3.from_array(np.eye(3))).to_numpy()
    assert np.allclose(c, [[0.25, 0.5, 0.75]] * 3)

    buf = np.zeros((8, 16, 3))
    buf[:, :, 0] = np.linspace(0, 1, 8)[:, None]
    hdri = tr.Hdri(buf)
    t = hdri.tables("cpu")
    red = hdri.get_color(t, TVec3.from_array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                                              [1.0, 0.0, 0.0]])).to_numpy()[:, 0]
    assert red[0] < 0.05 and red[1] > 0.95 and 0.3 < red[2] < 0.7

    buf = np.zeros((4, 8, 3))
    buf[:, :, 1] = np.linspace(0, 1, 8)[None, :]
    hdri = tr.Hdri(buf)
    green = hdri.get_color(hdri.tables("cpu"), TVec3.from_array(
        [[-1.0, 0.0, -1e-8], [1.0, 0.0, 0.0]])).to_numpy()[:, 1]
    assert green[0] < 0.1 and 0.4 < green[1] < 0.6
    with pytest.raises(ValueError, match="H, W, 3"):
        tr.Hdri(np.zeros((4, 8)))


def test_scene_takes_an_hdri():
    """`Scene.add` keeps an `Hdri` as the environment; the compiled table
    is the flat (H * W,) float32 map, and `lerp` is glm::mix."""
    buf = _map()
    scene = tr.Scene()
    hdri = tr.Hdri(buf)
    scene.add(hdri)
    scene.add(tr.Object(tr.sphere()))
    compiled = scene.compile("cpu")
    env = compiled.tables["env"]
    assert compiled.environment is hdri and env.x.shape == (H * W,)
    assert env.x.dtype == torch.float32
    assert np.array_equal(env.to_numpy(), buf.reshape(-1, 3).astype(np.float32))
    a, b = TVec3.of(0.0, 1.0, 2.0), TVec3.of(4.0, 5.0, 6.0)
    assert np.allclose(lerp(a, b, 0.25).to_numpy(), [1.0, 2.0, 3.0])
