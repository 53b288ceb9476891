"""The port's kernel modules on the CPU: the plain sphere sweep against the
Pallas kernel (interpret mode), the k-NN against the JAX grid and numpy
brute force, the device grid build, and the wrappers' device dispatch.
The kernels themselves run on the card in `test_torch_kernels.py`."""

import math

import jax.numpy as jnp
import numpy as np
import torch

from rpt_tpu.accel.grid import build_photon_grid
from rpt_tpu.accel.grid import knn_query as jax_knn_query
from rpt_tpu.ops.sphere_sweep import pack_spheres_transposed as jax_pack
from rpt_tpu.ops.sphere_sweep import sphere_sweep as jax_sphere_sweep
from rpt_tpu.vec import Vec3 as JVec3
from rpt_tpu_torch.accel.knn import build_grid, knn_query
from rpt_tpu_torch.ops.sphere_sweep import (
    SPHERE_CHUNK,
    pack_spheres_transposed,
    sphere_sweep,
    sphere_sweep_plain,
)


def _sweep_inputs(p, n, seed=0):
    """`tests/test_pallas_ops.py`'s inputs."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 100, (p, 3)).astype(np.float32)
    radius = rng.uniform(5.0, 10.0, p).astype(np.float32)
    direction = rng.normal(size=(p, 3)).astype(np.float32)
    power = rng.uniform(0, 1, (p, 3)).astype(np.float32)
    o = rng.uniform(0, 100, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit_t = np.where(rng.random(n) < 0.5, rng.uniform(20, 200, n), np.inf).astype(np.float32)
    return pos, radius, direction, power, o, d, hit_t


def test_pack_matches_jax():
    pos, radius, direction, power, *_ = _sweep_inputs(700, 1)
    ref = jax_pack(pos, radius, direction, power)
    got = pack_spheres_transposed(*(torch.tensor(a) for a in (pos, radius, direction, power)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_sweep_matches_pallas():
    """Plain version vs the Pallas kernel in interpret mode (rtol 1e-4,
    atol 1e-7: the MXU-shaped and the chunked sums add in other orders)."""
    p = SPHERE_CHUNK * 2
    n = 512 + 17
    pos, radius, direction, power, o, d, hit_t = _sweep_inputs(p, n)
    ext, phase = 1e-3, 1 / (4 * math.pi)
    color = np.full(3, 0.5, np.float32)
    ref = np.asarray(jax_sphere_sweep(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(hit_t),
        jnp.asarray(jax_pack(pos, radius, direction, power)), jnp.float32(ext),
        jnp.asarray(color), n_spheres=p, phase_const=phase, interpret=True,
    ))
    sph = pack_spheres_transposed(*(torch.tensor(a) for a in (pos, radius, direction, power)))
    args = (torch.tensor(o), torch.tensor(d), torch.tensor(hit_t), sph, ext, torch.tensor(color))
    got = sphere_sweep_plain(*args, n_spheres=p, phase_const=phase).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)
    assert (np.abs(ref).sum(1) > 0).mean() > 0.2  # rays do pierce spheres

    # the wrapper takes the plain version for CPU tensors, never the kernel
    before = sphere_sweep.launches
    np.testing.assert_array_equal(sphere_sweep(*args, n_spheres=p, phase_const=phase).numpy(), got)
    assert sphere_sweep.launches == before


def test_plain_sweep_ragged_and_partial():
    """Only the first n_spheres columns count; P and N need not be multiples
    of any block."""
    p, n = 1000, 333
    pos, radius, direction, power, o, d, hit_t = _sweep_inputs(p, n, seed=3)
    full = pack_spheres_transposed(*(torch.tensor(a) for a in (pos, radius, direction, power)))
    part = pack_spheres_transposed(*(torch.tensor(a[:700]) for a in (pos, radius, direction, power)))
    args = (torch.tensor(o), torch.tensor(d), torch.tensor(hit_t))
    a = sphere_sweep_plain(*args, full, 2e-3, torch.ones(3), n_spheres=700, phase_const=0.1)
    b = sphere_sweep_plain(*args, part, 2e-3, torch.ones(3), n_spheres=700, phase_const=0.1)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def _numpy_knn_d2(points, queries, k):
    """Brute force in numpy f32 with the kernel's operation order."""
    dx = points[None, :, 0] - queries[:, None, 0]
    dy = points[None, :, 1] - queries[:, None, 1]
    dz = points[None, :, 2] - queries[:, None, 2]
    return np.sort(dx * dx + dy * dy + dz * dz, axis=1)[:, :k]


def test_knn_plain_exact_and_matches_jax_grid():
    """Against numpy brute force exactly (sorted d2), and against the JAX
    grid k-NN with `tests/test_photon.py`'s agreement figure."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (4000, 3)).astype(np.float32)
    queries = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
    k = 12
    grid = build_grid(torch.tensor(pts))
    idx, d2, valid = knn_query(grid, torch.tensor(queries), k)
    assert valid.all()
    assert torch.equal(d2, torch.sort(d2, dim=1).values)
    np.testing.assert_array_equal(d2.numpy(), _numpy_knn_d2(pts, queries, k))
    # idx addresses the grid-sorted points
    gp = grid.points.numpy()
    recomputed = ((gp[idx.numpy()] - queries[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(recomputed, d2.numpy(), rtol=1e-5)

    static, tabs = build_photon_grid(pts.astype(np.float64), k=k)
    order = np.asarray(tabs["order"])
    pos4 = np.zeros((len(pts), 4), np.float32)
    pos4[:, :3] = pts[order]
    _, jd2, _ = jax_knn_query(static, tabs, jnp.asarray(pos4), JVec3.from_array(queries), k)
    close = np.isclose(np.sort(np.asarray(jd2), 1), d2.numpy(), rtol=2e-3, atol=1e-4)
    assert close.mean() > 0.995
