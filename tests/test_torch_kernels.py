"""The port's kernel wrappers without JAX: the device grid build, input
checks, and K-sweep and K-knn against their plain versions on the card.

This file imports neither jax nor rpt_tpu, so it also runs on a GPU
machine without JAX (`tests/conftest.py` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from rpt_tpu_torch.accel.knn import build_grid, knn_plain, knn_query
from rpt_tpu_torch.ops.sphere_sweep import pack_spheres_transposed, sphere_sweep, sphere_sweep_plain


def test_knn_fewer_points_than_k():
    pts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    idx, d2, valid = knn_query(build_grid(pts), torch.tensor([[0.2, 0.0, 0.0]]), 4)
    assert valid.tolist() == [[True, True, False, False]]
    assert idx[0, 2:].tolist() == [0, 0]
    np.testing.assert_allclose(d2[0, :2].numpy(), [0.04, 0.64], rtol=1e-6)


def test_grid_build_is_consistent():
    """Every point lies in its cell run, the order is a permutation, and a
    clustered cloud with strays stays within the cell budget."""
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.normal(0.0, 0.05, (3000, 3)), rng.uniform(-3, 3, (200, 3))])
    pts_t = torch.tensor(pts, dtype=torch.float32)
    grid = build_grid(pts_t)
    assert sorted(grid.order.tolist()) == list(range(len(pts)))
    assert torch.equal(grid.points, pts_t[grid.order])
    nx, ny, nz = grid.dims
    o = torch.tensor(grid.origin)
    c = torch.floor((grid.points - o) * (1.0 / grid.h)).long()
    c = torch.minimum(c.clamp(min=0), torch.tensor(grid.dims) - 1)
    cid = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    starts = grid.starts.long()
    lane = torch.arange(len(pts))
    assert bool(((starts[cid] <= lane) & (lane < starts[cid + 1])).all())
    assert int(starts[-1]) == len(pts) and len(starts) == nx * ny * nz + 1


def test_wrappers_reject_bad_inputs():
    grid = build_grid(torch.zeros((4, 3)))
    with pytest.raises(ValueError):
        knn_query(grid, torch.zeros((2, 3), dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        knn_query(grid, torch.zeros((2, 3)), 0)
    with pytest.raises(ValueError):
        sphere_sweep(torch.zeros((2, 3)), torch.zeros((2, 3)), torch.zeros(3),
                     torch.zeros((10, 512)), 0.0, torch.ones(3), n_spheres=1, phase_const=0.1)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K-sweep and K-knn against their plain versions on the card, at
    ragged sizes (N and P no multiple of a block); K-knn also for queries
    outside the grid and for both k of the photon path. Each wrapper
    launches its kernel once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = "cuda"
    rng = np.random.default_rng(0)
    p, n = 5003, 1000

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit_t = np.where(rng.random(n) < 0.5, rng.uniform(20, 200, n), np.inf)
    sph = pack_spheres_transposed(t(rng.uniform(0, 100, (p, 3))), t(rng.uniform(5, 10, p)),
                                  t(rng.normal(size=(p, 3))), t(rng.uniform(0, 1, (p, 3))))
    args = (t(rng.uniform(0, 100, (n, 3))), t(d), t(hit_t), sph, 1e-3, t([0.5, 0.6, 0.7]))
    before = sphere_sweep.launches
    got = sphere_sweep(*args, n_spheres=p, phase_const=0.1)
    assert sphere_sweep.launches == before + 1
    ref = sphere_sweep_plain(*args, n_spheres=p, phase_const=0.1)
    assert (ref.abs().sum(1) > 0).float().mean() > 0.2  # rays do pierce spheres
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-6 * float(ref.abs().max()))

    grid = build_grid(t(rng.normal(0, 1, (20000, 3))))
    q = t(rng.normal(0, 3, (2051, 3)))  # many outside the grid
    for k in (10, 20):
        before = knn_query.launches
        idx, d2, valid = knn_query(grid, q, k)
        assert knn_query.launches == before + 1
        _, d2p, _ = knn_plain(grid.points, q, k)
        assert valid.all() and torch.equal(d2, d2p)
        recomputed = ((grid.points[idx] - q[:, None, :]) ** 2).sum(-1)
        torch.testing.assert_close(recomputed, d2, rtol=1e-5, atol=1e-6)
