"""The port's kernel modules on the CPU: the plain sphere sweep against the
Pallas kernel (interpret mode), K-sweep's kernel-side table (Morton order,
32-byte records, tile bounds) and the plain version of its cull, the k-NN
against the JAX grid and numpy brute force, K-knn's walk of the grid's
levels in torch ops against both, the radius pass against the JAX package's,
the device grid build, and the wrappers' device dispatch. The kernels themselves run on the card in
`test_torch_kernels.py`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpt_tpu.accel.grid import build_photon_grid
from rpt_tpu.accel.grid import knn_query as jax_knn_query
from rpt_tpu.ops.sphere_sweep import pack_spheres_transposed as jax_pack
from rpt_tpu.ops.sphere_sweep import sphere_sweep as jax_sphere_sweep
from rpt_tpu.vec import Vec3 as JVec3
from rpt_tpu.integrators.photon import _knn_radius_device as jax_knn_radius
from rpt_tpu_torch import tracing
from rpt_tpu_torch.accel.knn import (
    build_grid, knn_levels_plain, knn_plain, knn_query, knn_radius, knn_radius_plain,
)
from rpt_tpu_torch.ops.sphere_sweep import (
    SPHERE_CHUNK,
    TILE,
    build_sphere_table,
    pack_spheres_transposed,
    pierced_count,
    pierced_count_plain,
    record_pierce_plain,
    sphere_sweep,
    sphere_sweep_plain,
    sqrt_threshold,
    tile_keep_plain,
)
from rpt_tpu_torch.ops.sphere_sweep import _pierce


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
    before = tracing.LAUNCHES["sphere_sweep"]
    np.testing.assert_array_equal(sphere_sweep(*args, n_spheres=p, phase_const=phase).numpy(), got)
    assert tracing.LAUNCHES["sphere_sweep"] == before


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


def _table_inputs(p, n, seed=0):
    """`_sweep_inputs` as tensors, a tenth of the radii zero (inert)."""
    pos, radius, direction, power, o, d, hit_t = _sweep_inputs(p, n, seed)
    radius[::10] = 0.0
    sph = pack_spheres_transposed(*(torch.tensor(a) for a in (pos, radius, direction, power)))
    return sph, torch.tensor(o), torch.tensor(d), torch.tensor(hit_t)


def test_morton_table_is_a_permutation_and_keeps_the_sum():
    """The kernel-side table holds every sphere once, in Morton order, with
    tiles far more compact than the input order's; the plain sweep over it
    matches the original order's within rtol 1e-5 (only the order of the
    sums differs)."""
    p, n = 3000, 200
    sph, o, d, hit_t = _table_inputs(p, n, seed=5)
    table = build_sphere_table(sph, p)
    assert torch.equal(torch.sort(table.order).values, torch.arange(p))
    assert torch.equal(table.spheres_t[:, :p], sph[:, table.order])
    assert not table.spheres_t[:, p:].any() and table.spheres_t.shape == sph.shape
    assert table.n_tiles == -(-p // TILE)
    assert table.records.shape == (table.n_tiles * TILE, 8)

    def volume(order):  # mean box volume of 128-sphere tiles
        pos = sph[0:3, :p].T[order][: p // 128 * 128].reshape(-1, 128, 3)
        return float((pos.amax(1) - pos.amin(1)).prod(dim=1).mean())

    assert volume(table.order) < 0.2 * volume(torch.arange(p))
    args = (0.7e-3, torch.tensor([0.5, 0.6, 0.7]))
    ref = sphere_sweep_plain(o, d, hit_t, sph, *args, n_spheres=p, phase_const=0.1)
    got = sphere_sweep_plain(o, d, hit_t, table.spheres_t, *args, n_spheres=p, phase_const=0.1)
    assert (ref.abs().sum(1) > 0).float().mean() > 0.2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-7 * float(ref.max()))
    # the wrapper takes a SphereTable on the CPU too, and launches nothing
    before = tracing.LAUNCHES["sphere_sweep"]
    np.testing.assert_array_equal(
        sphere_sweep(o, d, hit_t, table, *args, n_spheres=p, phase_const=0.1).numpy(), got.numpy())
    assert tracing.LAUNCHES["sphere_sweep"] == before


def test_sqrt_threshold_decides_as_the_square_root():
    """``oc2 <= th2`` equals ``sqrt(oc2) <= th`` for every oc2, at and
    around th^2, for misses (inf), NaN, zero and negative limits."""
    rng = np.random.default_rng(7)
    th = torch.tensor(np.concatenate([
        rng.uniform(0, 3, 300), rng.uniform(0, 2000, 300), 10.0 ** rng.uniform(-20, 19, 200),
        [np.inf, np.nan, 0.0, -0.0, -1.0, 1.0, 4.0, 3.4e38]]).astype(np.float32))
    th2 = sqrt_threshold(th)
    assert torch.isnan(th2[torch.isnan(th)]).all()
    sq = torch.where(th >= 0, th * th, torch.zeros_like(th))
    x = torch.stack([sq, torch.nextafter(sq, torch.zeros_like(sq)),
                     torch.nextafter(sq, torch.full_like(sq, np.inf)), sq * 1.0000005,
                     sq * 0.9999995, torch.rand(sq.shape) * sq * 2, torch.zeros_like(sq),
                     torch.full_like(sq, np.inf)], dim=1)
    x = torch.cat([x, torch.nextafter(x[:, :3], torch.full_like(x[:, :3], np.inf))], dim=1)
    assert torch.equal(x <= th2[:, None], torch.sqrt(x) <= th[:, None])


def test_records_reproduce_the_plain_pierce_decision():
    """K-sweep's decision on its 32-byte records (``dd > 0``, ``dist2 <
    r2'``, ``oc2 <= th2``) equals the plain version's on every pair,
    zero-radius spheres and the inert padding of the last tile included,
    with rays whose hit time lies exactly at a sphere's distance."""
    p, n = 700, 300
    sph, o, d, hit_t = _table_inputs(p, n, seed=9)
    table = build_sphere_table(sph, p)
    # put some hit times exactly at the rounded distance of a sphere
    oc = table.records[None, :p, 0:3] - o[:, None, :]
    oc2 = (oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1]) + oc[..., 2] * oc[..., 2]
    pick = torch.tensor(np.random.default_rng(1).integers(0, p, n))
    exact = torch.sqrt(oc2[torch.arange(n), pick])
    hit_t = torch.where(torch.arange(n) % 3 == 0, exact, hit_t)
    hit_t[1::7] = -1.0
    hit_t[2::11] = 0.0
    ok, *_ = _pierce(table.spheres_t[:, : table.records.shape[0]], *o.T[:, :, None],
                     *d.T[:, :, None], hit_t[:, None])
    got = record_pierce_plain(table.records, o, d, hit_t)
    assert torch.equal(got, ok)
    assert table.records.shape[0] > p and not got[:, p:].any()
    assert (table.records[:p, 3] == -1.0).sum() == (sph[3, :p] <= 0).sum() > 0
    assert 0.002 < ok.float().mean() < 0.2
    assert ok[torch.arange(n) % 3 == 0].any()


def _assert_cull_conservative(o, d, hit_t, table):
    """Every pair the plain pierce test counts lies in a tile the ray keeps.
    Returns (kept share of (ray, tile) pairs, pierced pairs)."""
    keep = tile_keep_plain(o, d, hit_t, table)
    ok = record_pierce_plain(table.records, o, d, hit_t)
    tile_of = torch.arange(table.records.shape[0]) // TILE
    rays, spheres = torch.nonzero(ok, as_tuple=True)
    assert bool(keep[rays, tile_of[spheres]].all())
    count = pierced_count_plain(o, d, hit_t, table.spheres_t, table.n_spheres)
    assert torch.equal(count, ok.sum(1))
    return float(keep.float().mean()), int(ok.sum())


def test_tile_keep_is_conservative_on_random_rays():
    p, n = 4000, 500
    sph, o, d, hit_t = _table_inputs(p, n, seed=2)
    share, pierced = _assert_cull_conservative(o, d, hit_t, build_sphere_table(sph, p))
    assert pierced > 1000 and share < 0.95


def test_tile_keep_is_conservative_where_float32_cancels():
    """The lampshade's scale: rays from ~1,400 units away (the camera at z =
    -800 before a 556-unit box) grazing spheres of radius 0.5, so that
    ``oc2 - dd*dd`` rounds by more than r^2. Each tile is 256 copies of one
    sphere (its box a point), and each ray passes 0.3-1.0 units from one
    of them: many pairs the float32 test pierces lie outside their sphere in
    exact arithmetic, so a cull by exact geometry would drop them; the
    plain cull keeps each, and culls every other tile."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 556, (16, 3))
    p, n = 16 * TILE, 2000
    centres = np.repeat(pts, TILE, axis=0)
    target = pts[rng.integers(0, 16, n)]
    o = np.array([278.0, 273.0, -800.0]) + rng.normal(0, 20, (n, 3))
    across = np.cross(target - o, rng.normal(size=(n, 3)))
    across /= np.linalg.norm(across, axis=1, keepdims=True)
    d = target + across * rng.uniform(0.3, 1.0, (n, 1)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit_t = np.where(rng.random(n) < 0.5, np.inf, np.linalg.norm(target - o, axis=1) + 1.0)
    f32 = [np.asarray(a, np.float32) for a in (centres, o, d, hit_t)]
    sph = pack_spheres_transposed(torch.tensor(f32[0]), torch.full((p,), 0.5),
                                  torch.zeros((p, 3)), torch.ones((p, 3)))
    o_t, d_t, th_t = (torch.tensor(a) for a in f32[1:])
    table = build_sphere_table(sph, p)
    share, pierced = _assert_cull_conservative(o_t, d_t, th_t, table)
    assert pierced > 10_000 and share < 0.07
    ok = record_pierce_plain(table.records, o_t, d_t, th_t)[:, :p].numpy()
    oc = table.spheres_t[0:3, :p].T.double().numpy()[None] - f32[1].astype(np.float64)[:, None]
    dd = (oc * f32[2].astype(np.float64)[:, None]).sum(-1)
    outside = ok & ((oc * oc).sum(-1) - dd * dd >= 0.25)
    assert outside.sum() > 1000


def test_tile_keep_is_conservative_for_misses_and_axis_rays():
    """Rays that hit nothing (hit_t inf), axis-parallel directions (1/d
    infinite on two axes), origins inside the cloud and on its box's
    planes, and NaN / negative hit times."""
    p = 3000
    rng = np.random.default_rng(6)
    sph, *_ = _table_inputs(p, 1, seed=6)
    table = build_sphere_table(sph, p)
    axes = np.eye(3)[rng.integers(0, 3, 400)] * rng.choice([-1.0, 1.0], (400, 1))
    o = rng.uniform(-20, 120, (400, 3))
    # origins on tile-bound planes: one coordinate copied from a tile's box
    lo = table.bounds[:, 0:3].numpy()
    pick = rng.integers(0, table.n_tiles, 100)
    o[:100, 0] = lo[pick, 0]
    o[:100, 1] = lo[pick, 1]
    hit_t = np.full(400, np.inf)
    hit_t[::9] = rng.uniform(0, 50, len(hit_t[::9]))
    hit_t[5::17] = np.nan
    hit_t[7::19] = -1.0
    o_t, d_t, th_t = (torch.tensor(np.asarray(a, np.float32)) for a in (o, axes, hit_t))
    share, pierced = _assert_cull_conservative(o_t, d_t, th_t, table)
    assert pierced > 500 and share < 0.8
    keep = tile_keep_plain(o_t, d_t, th_t, table)
    assert not keep[~(th_t >= 0)].any()  # NaN and negative limits keep nothing


def test_pierced_count_wrapper_on_the_cpu():
    """`pierced_count` on CPU tensors: the plain count per ray and, per
    block of 256 rays, the tiles one of its rays keeps."""
    p, n = 1500, 300
    sph, o, d, hit_t = _table_inputs(p, n, seed=8)
    table = build_sphere_table(sph, p)
    count, kept = pierced_count(o, d, hit_t, table)
    assert torch.equal(count, pierced_count_plain(o, d, hit_t, sph, p))
    keep = tile_keep_plain(o, d, hit_t, table)
    assert kept.tolist() == [int(keep[:256].any(0).sum()), int(keep[256:].any(0).sum())]


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


def _knn_clouds():
    """Four seeded clouds with their queries: ``name -> (points, queries)``."""
    rng = np.random.default_rng(21)

    def f32(a):
        return np.asarray(a, np.float32)

    planes = np.concatenate([
        np.c_[rng.uniform(0, 10, (1500, 2)), np.zeros(1500)],
        np.c_[np.full(1500, 3.0), rng.uniform(0, 10, (1500, 2))]])
    cluster = np.concatenate([rng.normal(0, 0.05, (3000, 3)), rng.uniform(-30, 30, (20, 3))])
    return {
        "uniform": (f32(rng.uniform(-5, 5, (4000, 3))), f32(rng.uniform(-5, 5, (200, 3)))),
        "two planes": (f32(planes), f32(rng.uniform(0, 10, (200, 3)))),
        # a dense body and 20 far outliers: queries in the body, on the
        # outliers and in the empty space between
        "cluster and outliers": (f32(cluster), f32(np.concatenate([
            cluster[:150], cluster[-20:], rng.uniform(-30, 30, (30, 3))]))),
        # fewer points than k, queried from inside and far outside the box
        "few points, outside queries": (f32(rng.uniform(0, 1, (7, 3))),
                                        f32(rng.uniform(-3, 4, (60, 3)))),
    }


@pytest.mark.parametrize("cloud", ["uniform", "two planes", "cluster and outliers",
                                   "few points, outside queries"])
def test_knn_levels_plain_is_exact(cloud):
    """K-knn's walk (start level from the own cell's count, the 3x3x3
    block, the covered-radius certificate, the next level up on failure)
    in torch ops, against brute force in torch and in numpy: sorted d2
    bit-equal, because all three round the same operations in the same
    order and the certificate only decides when to stop; the indices lie
    at their distances; and the clustered cloud's queries end on several
    levels (the levels do adapt)."""
    pts, queries = _knn_clouds()[cloud]
    grid = build_grid(torch.tensor(pts))
    q = torch.tensor(queries)
    for k in (10, 20, 12):
        idx, d2, valid, level = knn_levels_plain(grid, q, k)
        _, d2p, validp = knn_plain(grid.points, q, k)
        assert torch.equal(d2, d2p) and torch.equal(valid, validp)
        assert torch.equal(valid.sum(1), torch.full((len(queries),), min(k, len(pts))))
        gp = grid.points.numpy()
        ref = _numpy_knn_d2(gp, queries, k)
        np.testing.assert_array_equal(d2.numpy()[:, : ref.shape[1]], ref)
        at = ((gp[idx.numpy()] - queries[:, None, :]) ** 2).sum(-1)
        np.testing.assert_allclose(at[valid.numpy()], d2.numpy()[valid.numpy()], rtol=1e-5,
                                   atol=1e-12)
        if cloud == "cluster and outliers":
            assert len(torch.unique(level)) >= 4
            assert int(level.max()) - int(level.min()) >= 6


def test_knn_radius_matches_jax_radius():
    """`knn_radius` on the CPU (the plain version: the k-th nearest
    distance^2, itself included) against the JAX package's radius pass,
    with the agreement `test_knn_plain_exact_and_matches_jax_grid` states
    for the same reason (the JAX grid truncates a few queries): rtol 2e-3
    on > 99.5% of points. A cloud of fewer than k points gets its largest
    distance."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    k = 10
    grid = build_grid(torch.tensor(pts))
    radius = torch.sqrt(knn_radius(grid, k)).numpy()
    assert torch.equal(knn_radius(grid, k), knn_radius_plain(grid, k))
    gp = grid.points.numpy()
    np.testing.assert_array_equal(knn_radius(grid, k).numpy(), _numpy_knn_d2(gp, gp, k)[:, k - 1])

    static, tabs = build_photon_grid(pts.astype(np.float64), k=k)
    jorder = np.asarray(tabs["order"])
    pos4 = np.zeros((len(pts), 4), np.float32)
    pos4[:, :3] = pts[jorder]
    tabs = dict(tabs, pos4=jnp.asarray(pos4), pos4_2=jnp.asarray(pos4[np.asarray(tabs["map2"])]))
    jradius = np.empty(len(pts), np.float32)
    jradius[jorder] = jax_knn_radius(static, tabs, len(pts), k)[: len(pts)]
    close = np.isclose(jradius[grid.order.numpy()], radius, rtol=2e-3, atol=1e-4)
    assert close.mean() > 0.995

    few = build_grid(torch.tensor(pts[:4]))
    d = np.sqrt(((pts[:4, None, :] - pts[None, :4, :]) ** 2).sum(-1)).max(1)
    np.testing.assert_allclose(torch.sqrt(knn_radius(few, k)).numpy(),
                               d[few.order.numpy()], rtol=1e-6)
