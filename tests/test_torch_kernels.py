"""The port's kernel wrappers without JAX: the device grid build and the
self-query's unit cut, input checks, and K-sweep, K-knn, K1, K2, K-rng and
K-prim against their plain versions on the card.

This file imports neither jax nor rpt_tpu, so it also runs on a GPU
machine without JAX (`tests/conftest.py` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from rpt_tpu_torch import tracing
from rpt_tpu_torch.accel.bvh import BVHTables, build_bvh, pack_bvh
from rpt_tpu_torch.accel.knn import (
    LEVELS, REGISTER_K, UNIT, build_grid, cell_coords, cell_runs, knn_plain, knn_query, knn_query_counts,
    knn_radius, knn_radius_counts, knn_radius_plain, morton_code, radius_units_plain,
)
from rpt_tpu_torch.ops.bvh_traverse import (
    bvh_any_hit, bvh_any_hit_plain, bvh_closest_hit, bvh_closest_hit_plain, traverse_counts,
)
from rpt_tpu_torch.ops.sphere_sweep import (
    build_sphere_table, pack_spheres_transposed, pierced_count, pierced_count_plain, sphere_sweep,
    sphere_sweep_plain,
)


def _random_mesh(n_tris, seed, device="cpu"):
    """A soup of ``n_tris`` random triangles in [-1, 1]^3 (sizes ragged,
    leaves partly filled), packed."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, (n_tris, 1, 3))
    v = centre + rng.normal(0, 0.08, (n_tris, 3, 3))
    nodes, leaves, shade, depth = pack_bvh(build_bvh(v.min(1), v.max(1)), v, v,
                                           np.zeros(n_tris, np.int32))
    return BVHTables(*(torch.from_numpy(a).to(device) for a in (nodes, leaves, shade)), depth)


def test_knn_fewer_points_than_k():
    pts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    idx, d2, valid = knn_query(build_grid(pts), torch.tensor([[0.2, 0.0, 0.0]]), 4)
    assert valid.tolist() == [[True, True, False, False]]
    assert idx[0, 2:].tolist() == [0, 0]
    np.testing.assert_allclose(d2[0, :2].numpy(), [0.04, 0.64], rtol=1e-6)


def _strays_cloud():
    """A dense cluster with strays around it, as a photon cloud's body in
    its halo, and 40 coincident points (a crowded finest cell)."""
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.normal(0.0, 0.05, (3000, 3)), rng.uniform(-3, 3, (200, 3)),
                          np.full((40, 3), 0.25)])
    return torch.tensor(pts, dtype=torch.float32)


def test_grid_build_is_consistent():
    """The order is a permutation, the codes ascend and are the Morton
    codes of the points' finest cells, the rows are the padded points, and
    at every level the cells' runs partition the array: a run per distinct
    prefix, each starting where the last ended, each the union of its
    children's."""
    pts_t = _strays_cloud()
    n = len(pts_t)
    grid = build_grid(pts_t)
    assert sorted(grid.order.tolist()) == list(range(n))
    assert torch.equal(grid.points, pts_t[grid.order])
    assert torch.equal(grid.rows[:, :3], grid.points) and not bool(grid.rows[:, 3].any())
    assert bool((grid.codes[1:] >= grid.codes[:-1]).all())
    assert torch.equal(grid.codes, morton_code(cell_coords(grid.points, grid.origin, grid.h)))
    assert 0 <= int(grid.codes.min()) and int(grid.codes.max()) < 8 ** LEVELS
    lane = torch.arange(n)
    below = None
    for level in range(LEVELS + 1):
        prefix = grid.codes >> (3 * level)
        start, count = cell_runs(grid, prefix, level)
        assert bool(((start <= lane) & (lane < start + count)).all())
        cells, sizes = torch.unique_consecutive(prefix, return_counts=True)
        first, length = cell_runs(grid, cells, level)
        assert torch.equal(length, sizes)
        assert torch.equal(first, torch.cumsum(sizes, 0) - sizes)
        if below is not None:  # a cell's run is its children's runs joined
            child_cells, child_sizes = below
            joined = torch.zeros(len(cells), dtype=torch.int64).index_add_(
                0, torch.searchsorted(cells, child_cells >> 3), child_sizes)
            assert torch.equal(joined, sizes)
        below = (cells, sizes)
    assert len(below[0]) == 1 and int(below[1][0]) == n  # the top level is one cell


def test_radius_units_partition_the_points():
    """The self-query's units (`radius_units_plain`, the kernel's cut in
    torch ops): runs that partition the array, each of at most UNIT points
    and all in one cell of its level, whose parent cell holds more than
    UNIT (or the unit is a run of a crowded finest cell)."""
    grid = build_grid(_strays_cloud())
    start, count, level = radius_units_plain(grid)
    lane = torch.arange(grid.n)
    assert bool(((start <= lane) & (lane < start + count)).all())
    heads = torch.unique(start)
    assert int(count[heads].sum()) == grid.n and int(count.max()) <= UNIT
    assert torch.equal(heads[1:], (heads + count[heads])[:-1])
    crowded = cell_runs(grid, grid.codes, 0)[1] > UNIT
    assert int(crowded.sum()) == 40 and bool((level[crowded] == 0).all())
    for i in heads[~crowded[heads]].tolist():
        lv = int(level[i])
        members = grid.codes[i : i + int(count[i])] >> (3 * lv)
        assert bool((members == members[0]).all())
        assert int(cell_runs(grid, members[:1], lv)[1]) == int(count[i])
        if lv < LEVELS:
            assert int(cell_runs(grid, members[:1] >> 3, lv + 1)[1]) > UNIT
    assert len(torch.unique(level)) >= 4  # the strays' units are coarser than the body's


def test_knn_wrappers_on_empty_clouds_and_bad_k():
    """An empty cloud builds, answers with no valid neighbour and an empty
    radius list; k outside [1, MAX_K] is refused by both wrappers, and the
    radius pass takes only k in `REGISTER_K`; on the CPU neither wrapper
    launches anything."""
    empty = build_grid(torch.zeros((0, 3)))
    before = tracing.LAUNCHES.copy()
    idx, d2, valid = knn_query(empty, torch.zeros((3, 3)), 5)
    assert idx.shape == d2.shape == valid.shape == (3, 5) and not bool(valid.any())
    assert knn_radius(empty, 10).shape == (0,)
    grid = build_grid(torch.rand((50, 3), generator=torch.Generator().manual_seed(0)))
    for k in REGISTER_K:
        assert torch.equal(knn_radius(grid, k), knn_plain(grid.points, grid.points, k)[1][:, -1])
    for k in (0, 1, 3, 129):
        with pytest.raises(ValueError):
            knn_radius(grid, k)
    for k in (0, 129):
        with pytest.raises(ValueError):
            knn_query(grid, torch.zeros((2, 3)), k)
    assert tracing.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    grid = build_grid(torch.zeros((4, 3)))
    with pytest.raises(ValueError):
        knn_query(grid, torch.zeros((2, 3), dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        knn_query(grid, torch.zeros((2, 3)), 0)
    with pytest.raises(ValueError):
        sphere_sweep(torch.zeros((2, 3)), torch.zeros((2, 3)), torch.zeros(3),
                     torch.zeros((10, 512)), 0.0, torch.ones(3), n_spheres=1, phase_const=0.1)
    bvh = _random_mesh(100, 0)
    o, d, t = torch.zeros((2, 3)), torch.ones((2, 3)), torch.ones(2)
    with pytest.raises(ValueError):  # dtype
        bvh_closest_hit(bvh, o.double(), d, 0.0, t)
    with pytest.raises(ValueError):  # shape
        bvh_closest_hit(bvh, o, d, 0.0, torch.ones(3))
    with pytest.raises(ValueError):  # contiguity
        bvh_any_hit(bvh, o, torch.ones((3, 2)).T, 0.0, t)
    with pytest.raises(ValueError):  # mask type
        bvh_any_hit(bvh, o, d, 0.0, t, active=torch.ones(2))
    with pytest.raises(ValueError):  # a tree deeper than the kernels' stack
        bvh_any_hit(BVHTables(bvh.nodes, bvh.leaves, bvh.shade, 72), o, d, 0.0, t)


def _clustered_case(rng, p, n, t):
    """``p`` small spheres in 40 tight clusters (the photon cloud's shape;
    5% zero radii), and ``n`` rays in coherent bundles of 256, as camera
    rays come in Morton pixel order: each bundle leaves one point towards
    one cluster, half of its rays stopping on the way."""
    hubs = rng.uniform(0, 100, (40, 3))
    centres = hubs[rng.integers(0, 40, p)] + rng.normal(0, 1.5, (p, 3))
    radius = np.where(rng.random(p) < 0.05, 0.0, rng.uniform(0.2, 1.5, p))
    sph = pack_spheres_transposed(t(centres), t(radius), t(rng.normal(size=(p, 3))),
                                  t(rng.uniform(0, 1, (p, 3))))
    bundle = np.arange(n) // 256
    o = rng.uniform(-20, 120, (bundle[-1] + 1, 3))[bundle] + rng.normal(0, 0.5, (n, 3))
    d = hubs[rng.integers(0, 40, bundle[-1] + 1)][bundle] + rng.normal(0, 2.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit_t = np.where(rng.random(n) < 0.5, rng.uniform(5, 150, n), np.inf)
    return sph, t(o), t(d), t(hit_t)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K-sweep and K-knn against their plain versions on the card, at
    ragged sizes (N and P no multiple of a block); K-sweep also on a
    clustered cloud whose Morton tiles the cull mostly drops, with the
    pierced-pair count of every ray equal to the plain count, two calls
    bit-identical, and a bare (FIELDS, P) table refused; K-knn also for
    queries outside the grid and for both k of the photon path. Each
    wrapper launches its kernel once per call."""
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
    with pytest.raises(ValueError, match="SphereTable"):
        sphere_sweep(*args, n_spheres=p, phase_const=0.1)
    table = build_sphere_table(sph, p)
    before = tracing.LAUNCHES["sphere_sweep"]
    got = sphere_sweep(*args[:3], table, *args[4:], n_spheres=p, phase_const=0.1)
    assert tracing.LAUNCHES["sphere_sweep"] == before + 1
    ref = sphere_sweep_plain(*args, n_spheres=p, phase_const=0.1)
    assert (ref.abs().sum(1) > 0).float().mean() > 0.2  # rays do pierce spheres
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-6 * float(ref.abs().max()))

    # clustered, Morton-tiled: the cull drops most tiles and no pierced
    # pair
    sphc, oc, dc, thc = _clustered_case(rng, 20011, 3000, t)
    table = build_sphere_table(sphc, 20011)
    argc = (oc, dc, thc, table, 1.1e-3, t([0.5, 0.6, 0.7]))
    got = sphere_sweep(*argc, n_spheres=20011, phase_const=0.08)
    again = sphere_sweep(*argc, n_spheres=20011, phase_const=0.08)
    assert torch.equal(got, again)
    ref = sphere_sweep_plain(oc, dc, thc, sphc, *argc[4:], n_spheres=20011, phase_const=0.08)
    assert (ref.abs().sum(1) > 0).float().mean() > 0.3
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-6 * float(ref.abs().max()))
    before = tracing.LAUNCHES["sphere_sweep"]
    count, kept = pierced_count(oc, dc, thc, table)
    assert tracing.LAUNCHES["sphere_sweep"] == before  # counted as `pierced_count`
    assert torch.equal(count.long(), pierced_count_plain(oc, dc, thc, sphc, 20011))
    assert int(count.sum()) > 10_000 and kept.shape == (12,)
    assert int(kept.sum()) < 0.5 * kept.numel() * table.n_tiles

    grid = build_grid(t(rng.normal(0, 1, (20000, 3))))
    q = t(rng.normal(0, 3, (2051, 3)))  # many outside the grid
    for k in (10, 20):
        before = tracing.LAUNCHES["knn_query"]
        idx, d2, valid = knn_query(grid, q, k)
        assert tracing.LAUNCHES["knn_query"] == before + 1
        _, d2p, _ = knn_plain(grid.points, q, k)
        assert valid.all() and torch.equal(d2, d2p)
        recomputed = ((grid.points[idx] - q[:, None, :]) ** 2).sum(-1)
        torch.testing.assert_close(recomputed, d2, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_knn_kernels_match_plain_on_card():
    """K-knn's query and self-query kernels against brute force on the
    card: a dense body with far outliers and coincident points (crowded
    cells are opened, units of every level, the crowded finest cell cut
    into runs), queries in the body, on the outliers and far outside, for
    the register k (10, 20), a k of the one-register warp list (12) and
    one of the two-register list (50), the self-query at its k (10, 20;
    10 beside the other two); and a cloud of fewer than k points.
    Sorted d^2 bit-equal (the same rounded operations), indices distinct
    and at their distances; each wrapper launches once per call, the
    query's counting variant runs for every list (k = 20, 50, 100) and the
    counting variants count no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(0, 0.5, (60000, 3)), rng.uniform(-300, 300, (40, 3)),
                          np.full((70, 3), 0.125)])
    grid = build_grid(torch.tensor(pts, dtype=torch.float32, device="cuda"))
    q = torch.cat([grid.points[torch.randint(0, grid.n, (1500,), device="cuda")],
                   torch.tensor(pts[60000:60040], dtype=torch.float32, device="cuda"),
                   torch.tensor(rng.uniform(-400, 400, (211, 3)), dtype=torch.float32,
                                device="cuda")])
    for k in (10, 20, 12, 50):
        before = tracing.LAUNCHES.copy()
        idx, d2, valid = knn_query(grid, q, k)
        radius = knn_radius(grid, k if k in REGISTER_K else 10)
        assert tracing.LAUNCHES - before == {"knn_query": 1, "knn_radius": 1}
        _, d2p, _ = knn_plain(grid.points, q, k)
        assert valid.all() and torch.equal(d2, d2p)
        at = ((grid.points[idx] - q[:, None, :]) ** 2).sum(-1)
        torch.testing.assert_close(at, d2, rtol=1e-5, atol=1e-6)
        ranked = torch.sort(idx, dim=1).values
        assert bool((ranked[:, 1:] != ranked[:, :-1]).all())
        assert torch.equal(radius, knn_radius_plain(grid, k if k in REGISTER_K else 10))
    before = tracing.LAUNCHES.copy()
    for k in (20, 50, 100):
        counts = knn_query_counts(grid, q, k)
        assert counts.shape == (len(q), 4) and int(counts[:, 0].min()) >= 1
        assert int(counts[:, 2].min()) >= k  # every query tests at least k candidates
    counts = knn_radius_counts(grid, 10)
    assert counts.shape == (grid.n, 4) and int(counts[:, 3].max()) <= UNIT
    # the counting variants count under their own names
    assert tracing.LAUNCHES - before == {"knn_query_counts": 3, "knn_radius_counts": 1}

    few = build_grid(torch.tensor(pts[:6], dtype=torch.float32, device="cuda"))
    idx, d2, valid = knn_query(few, q[:50], 10)
    _, d2p, validp = knn_plain(few.points, q[:50], 10)
    assert torch.equal(d2, d2p) and torch.equal(valid, validp) and int(valid.sum()) == 300
    assert torch.equal(knn_radius(few, 10), knn_radius_plain(few, 10))


# the photon-map lampshade's volume and surface gather sizes (30, 100),
# `Renderer`'s default (50), and the two lists' widest k (64, 128)
GATHER_K = (30, 50, 64, 100, 128)


@pytest.mark.parametrize("k", GATHER_K)
def test_knn_plain_at_gather_sizes(k):
    """`knn_plain` (what `knn_query` runs on the CPU) at the photon-map
    kind's k against a numpy sort of all distances, on the body-in-a-halo
    cloud: d^2 ascending and equal to the sorted distances (the same f32
    operations: rtol 1e-6), indices distinct and at their distances; a
    cloud of fewer than k points pads with invalid entries."""
    pts = _strays_cloud()
    rng = np.random.default_rng(k)
    q = torch.cat([pts[rng.integers(0, len(pts), 200)],
                   torch.tensor(rng.uniform(-4, 4, (56, 3)), dtype=torch.float32)])
    grid = build_grid(pts)
    idx, d2, valid = knn_query(grid, q, k)
    assert idx.shape == d2.shape == valid.shape == (256, k) and bool(valid.all())
    diff = grid.points.numpy()[None, :, :] - q.numpy()[:, None, :]
    dist = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
            + diff[..., 2] * diff[..., 2])
    np.testing.assert_allclose(d2.numpy(), np.sort(dist, axis=1)[:, :k], rtol=1e-6)
    np.testing.assert_allclose(np.take_along_axis(dist, idx.numpy(), axis=1), d2.numpy(),
                               rtol=1e-6)
    ranked = np.sort(idx.numpy(), axis=1)
    assert (ranked[:, 1:] != ranked[:, :-1]).all() and bool((d2[:, 1:] >= d2[:, :-1]).all())
    _, d2f, validf = knn_query(build_grid(pts[:7]), q[:5], k)
    assert validf.sum(dim=1).tolist() == [7] * 5 and bool(torch.isinf(d2f[:, 7:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", GATHER_K)
def test_knn_query_at_gather_sizes_on_card(k):
    """K-knn's query kernel at the photon gathers' k (30: one register a
    lane; 50, 64: two; 100, 128: four) against brute force on the card, on
    the body-with-outliers cloud of `test_knn_kernels_match_plain_on_card`:
    sorted d^2 bit-equal, indices distinct and at their distances, one
    launch a call; and on a cloud of fewer than k points, the padding
    invalid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(0, 0.5, (60000, 3)), rng.uniform(-300, 300, (40, 3)),
                          np.full((170, 3), 0.125)])
    grid = build_grid(torch.tensor(pts, dtype=torch.float32, device="cuda"))
    q = torch.cat([grid.points[torch.randint(0, grid.n, (3000,), device="cuda")],
                   torch.tensor(pts[60000:60040], dtype=torch.float32, device="cuda"),
                   torch.tensor(rng.uniform(-400, 400, (211, 3)), dtype=torch.float32,
                                device="cuda")])
    before = tracing.LAUNCHES["knn_query"]
    idx, d2, valid = knn_query(grid, q, k)
    assert tracing.LAUNCHES["knn_query"] == before + 1
    _, d2p, _ = knn_plain(grid.points, q, k)
    assert bool(valid.all()) and torch.equal(d2, d2p)
    at = ((grid.points[idx] - q[:, None, :]) ** 2).sum(-1)
    torch.testing.assert_close(at, d2, rtol=1e-5, atol=1e-6)
    ranked = torch.sort(idx, dim=1).values
    assert bool((ranked[:, 1:] != ranked[:, :-1]).all())
    few = build_grid(grid.points[: k - 7].contiguous())
    _, d2, valid = knn_query(few, q[:64], k)
    _, d2p, validp = knn_plain(few.points, q[:64], k)
    assert torch.equal(d2, d2p) and torch.equal(valid, validp)
    assert valid.sum(dim=1).tolist() == [k - 7] * 64


def test_plain_traversal_matches_brute_force():
    """The plain K1/K2 (the ordered traversal) against the dense test of
    every leaf row on a random soup: the same algebra on the same
    triangles, in another order, so the same triangle and bit-equal t on
    every lane (a soup has no shared edges to tie on), and the same any-hit
    flags. The wrappers take the plain version for CPU tensors and launch
    nothing."""
    from rpt_tpu_torch.ops.dense_tri_hit import dense_tri_hit_plain
    from rpt_tpu_torch.ray import Hit, Ray
    from rpt_tpu_torch.vec import Vec3

    bvh = _random_mesh(700, 3)
    rng = np.random.default_rng(4)
    n = 1500
    o = rng.uniform(-1.5, 1.5, (n, 3))
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.tensor(a, dtype=torch.float32) for a in (o, d))
    inf = torch.full((n,), float("inf"))
    before = tracing.LAUNCHES.copy()
    t, tri, *_ = bvh_closest_hit(bvh, o, d, 1e-4, inf)
    ray = Ray(Vec3(o[:, 0], o[:, 1], o[:, 2]), Vec3(d[:, 0], d[:, 1], d[:, 2]))
    dense = dense_tri_hit_plain(bvh, ray, 1e-4, Hit.none((n,)))
    assert 0.3 < torch.isfinite(t).float().mean() < 0.95
    assert torch.equal(t, dense.time)
    limit = torch.tensor(rng.uniform(-0.5, 2.5, n), dtype=torch.float32)
    occ = bvh_any_hit(bvh, o, d, 1e-4, limit)
    assert 0.1 < occ.float().mean() < 0.9
    assert torch.equal(occ, dense.time < limit)
    assert tracing.LAUNCHES == before


@pytest.mark.cuda
def test_bvh_kernels_match_plain_on_card():
    """K1 and K2 against their plain versions on the card, on a ragged
    random soup of 3001 triangles and 5003 rays (no multiple of a block),
    with lanes masked off, per-lane limits and best times, and lanes with
    limit -1 (K2): the same triangle (K1)
    and flag (K2) on >= 99.9% of lanes; where the triangle agrees, t
    within rtol 1e-6 and u, v, w within rtol 1e-6 and atol 1e-6 (they lie
    in [0, 1], often near 0). Each wrapper launches its kernel once per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = "cuda"
    bvh = _random_mesh(3001, 1, dev)
    rng = np.random.default_rng(2)
    n = 5003
    o = rng.uniform(-1.5, 1.5, (n, 3))
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d))
    best = torch.tensor(np.where(rng.random(n) < 0.2, rng.uniform(0.5, 2, n), np.inf),
                        dtype=torch.float32, device=dev)
    limit = torch.tensor(np.where(rng.random(n) < 0.1, -1.0, rng.uniform(0.2, 3, n)),
                         dtype=torch.float32, device=dev)
    active = torch.tensor(rng.random(n) > 0.1, device=dev)
    t_min = 1e-4

    before = tracing.LAUNCHES["bvh_closest_hit"]
    got = bvh_closest_hit(bvh, o, d, t_min, best, limit=limit.abs() * 2, active=active)
    assert tracing.LAUNCHES["bvh_closest_hit"] == before + 1
    ref = bvh_closest_hit_plain(bvh, o, d, t_min, best, limit=limit.abs() * 2, active=active)
    same = got[1] == ref[1]
    assert same.float().mean() >= 0.999
    assert 0.3 < (ref[1] >= 0).float().mean() < 0.95
    assert bool((got[1][~active] == -1).all()) and torch.equal(got[0][~active], best[~active])
    torch.testing.assert_close(got[0][same], ref[0][same], rtol=1e-6, atol=0.0)
    hit = same & (ref[1] >= 0)
    for a, b in zip(got[2:], ref[2:]):
        torch.testing.assert_close(a[hit], b[hit], rtol=1e-6, atol=1e-6)

    before = tracing.LAUNCHES["bvh_any_hit"]
    occ = bvh_any_hit(bvh, o, d, t_min, limit, active=active)
    assert tracing.LAUNCHES["bvh_any_hit"] == before + 1
    occ_ref = bvh_any_hit_plain(bvh, o, d, t_min, limit, active=active)
    assert 0.1 < occ_ref.float().mean() < 0.9
    assert (occ == occ_ref).float().mean() >= 0.999
    assert not bool(occ[~active | (limit < 0)].any())

    # a wavefront with 90% of its lanes masked off: the blocks pack the
    # few that enter, and every result lands on its own lane
    sparse = torch.tensor(rng.random(n) < 0.1, device=dev)
    got = bvh_closest_hit(bvh, o, d, t_min, best, active=sparse)
    ref = bvh_closest_hit_plain(bvh, o, d, t_min, best, active=sparse)
    assert (got[1] == ref[1]).float().mean() >= 0.999
    assert bool((got[1][~sparse] == -1).all()) and torch.equal(got[0][~sparse], best[~sparse])
    occ = bvh_any_hit(bvh, o, d, t_min, limit.abs(), active=sparse)
    occ_ref = bvh_any_hit_plain(bvh, o, d, t_min, limit.abs(), active=sparse)
    assert (occ == occ_ref).float().mean() >= 0.999 and not bool(occ[~sparse].any())
    before = tracing.LAUNCHES.copy()
    counts, live_share = traverse_counts(True, bvh, o, d, t_min, limit.abs(), active=sparse)
    assert tracing.LAUNCHES - before == {"traverse_counts": 1}
    assert bool((counts[~sparse] == 0).all()) and bool((counts[sparse, 0] > 0).all())
    assert 0.0 < live_share <= 1.0


@pytest.mark.cuda
def test_threefry_kernels_match_plain_on_card():
    """K-rng against its plain version on the card, bit for bit on every
    element: fold (one key x wide data, a batch x an int, a batch x a
    batch, (A, B) keys, (A, 1) keys x (B,) data), split, uniform at three
    ranges, uniform2, uniform3 and the raw words, at 1000 lanes (no
    multiple of a block); the draw form (chains of 0-8 tags after an
    optional data word, 1-8 draws, the key written) against its unfused
    composition `draw_plain`, at 1000 lanes and at 270,001. Each wrapper launches its kernel once per call; an
    empty batch launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from rpt_tpu_torch.ops import threefry as tf

    dev, n = "cuda", 1000
    rng = np.random.default_rng(3)
    key = torch.tensor([7, 2**32 - 3], dtype=torch.int64, device=dev)
    keys = torch.tensor(rng.integers(0, 2**32, (n, 2)), dtype=torch.int64, device=dev)
    data = torch.tensor(np.concatenate([rng.integers(-2**40, 2**40, n - 3), [-1, 2**31, 2**32]]),
                        dtype=torch.int64, device=dev)
    grid = keys[:980].reshape(49, 20, 2)
    column = keys[:49].reshape(49, 1, 2)

    def launched(wrapper, *args):
        before = tracing.LAUNCHES[wrapper.__name__]
        out = wrapper(*args)
        assert tracing.LAUNCHES[wrapper.__name__] == before + 1
        return out

    for k, d in ((key, data), (key, 5), (keys, 2**32 + 7), (keys, data), (grid, 3),
                 (grid, data[:980].reshape(49, 20)), (column, data[:20])):
        assert torch.equal(launched(tf.threefry_fold, k, d), tf.fold_in_plain(k, d))
    assert torch.equal(launched(tf.threefry_split, key, n), tf.keys_for_plain(key, n))
    for lo, hi in ((-1.0 / 512.0, 1.0 / 512.0), (-0.25, 0.25), (0.0, 1.0)):
        (u,) = launched(tf.threefry_uniform, keys, 1, lo, hi)
        assert torch.equal(u.view(torch.int32), tf.uniforms_plain(keys, 1, lo, hi)[0]
                           .view(torch.int32))
    for count, k in ((2, keys), (3, keys), (3, grid)):
        for a, b in zip(launched(tf.threefry_uniform, k, count), tf.uniforms_plain(k, count)):
            assert a.is_contiguous() and torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(launched(tf.threefry_bits, grid, 3), tf.random_bits_plain(grid, 3))
    before = tracing.LAUNCHES["threefry_fold"]
    assert tf.threefry_fold(keys[:0], 1).shape == (0, 2)
    assert tracing.LAUNCHES["threefry_fold"] == before

    # the draw form: each of its call forms
    D = tf.Draw
    camera = (D((1,), 1, -1.0 / 600.0, 1.0 / 600.0), D((2,), 1, -1.0 / 600.0, 1.0 / 600.0),
              D((3, 0xD0F), 2))
    forms = ((key, data, (7,), camera, False),
             (keys, None, (4, 1, 3), (D((0xB5DF,), 2), D((0xF7E5,))), False),
             (keys, None, (), (D(),), False),
             (grid, None, (2**32 + 3, 5), (D((), 3),), True),
             (key, data, (7, 4), (), True),
             (column, data[:20], (9,), (D((1,), 2),), True),
             (keys, data, tuple(range(tf.MAX_TAGS)),
              tuple(D((i, i + 1)[:i % 3], 1 + i % 3, -0.25, 0.25) for i in range(tf.MAX_DRAWS)),
              True))
    # many blocks, the last one partial
    wide = torch.tensor(rng.integers(0, 2**32, (270_001, 2)), dtype=torch.int64, device=dev)
    forms += ((wide, None, (4, 2), (D((0x5A1,), 2), D((0xF7E5,))), True),)
    for k, d, tags, draws, key_out in forms:
        floats, out_keys = launched(tf.threefry_draw, k, d, tags, draws, key_out)
        ref, ref_keys = tf.draw_plain(k, d, tags, draws, key_out)
        assert len(floats) == len(ref) == sum(x.count for x in draws)
        for a, b in zip(floats, ref):
            assert a.is_contiguous() and torch.equal(a.view(torch.int32),
                                                     b.contiguous().view(torch.int32))
        assert (out_keys is None) == (not key_out)
        assert not key_out or torch.equal(out_keys, ref_keys)
    before = tracing.LAUNCHES["threefry_draw"]
    assert tf.threefry_draw(keys[:0], None, (1,), camera)[0][0].shape == (0,)
    assert tracing.LAUNCHES["threefry_draw"] == before


def _prim_scene(name):
    """A scene for K-prim on the card: the fractal's 937 spheres and wall,
    `monomial_glass` (every prim type), or 40 random rotated cubes."""
    import math
    import os
    import sys

    import rpt_tpu_torch as rpt

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    if name == "fractal":
        import torch_fractal_spheres

        return torch_fractal_spheres.build_scene().compile("cuda")
    if name == "monomial":
        import torch_monomial_glass

        return torch_monomial_glass.build_scene().compile("cuda")
    rng = np.random.default_rng(5)
    scene = rpt.Scene()
    for k in range(40):
        scene.add(rpt.Object(rpt.cube().rotate_y(rng.uniform(0, math.pi))
                             .scale(tuple(rng.uniform(0.1, 0.6, 3)))
                             .translate(tuple(rng.uniform(-2, 2, 3)))).material(
            rpt.Material.diffuse(rpt.hex_color(0x010101 * (k + 1)))))
    return scene.compile("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name, n", [("fractal", 5003), ("monomial", 5003), ("cubes", 5003),
                                     ("fractal", 270_001)])
def test_prim_kernels_match_plain_on_card(name, n):
    """K-prim's two entries against the per-type chain on the card, on rays
    from a shell around the scene toward it and, for half of them, from
    their first hits in random directions (n lanes, no multiple of a
    block): hit or miss and material equal on >= 99.99% of lanes, time
    within rtol 1e-6 and normals within atol 1e-6 where they agree; the
    any-hit flags (limits in [-1, 10), -1 on a tenth of the lanes) equal on
    >= 99.99% of lanes and False where limit <= t_min. One launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from rpt_tpu_torch.intersect import closest_hit
    from rpt_tpu_torch.ops import prim_hit as ph
    from rpt_tpu_torch.ray import Ray
    from rpt_tpu_torch.vec import Vec3

    scene = _prim_scene(name)
    prims, dev = scene.prim_rows, "cuda"
    rng = np.random.default_rng(n)
    o = rng.normal(size=(n, 3))
    o = 8.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-2, 2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = Ray(Vec3.from_array(o, dev), Vec3.from_array(d, dev))
    first = closest_hit(scene, scene.tables, ray)
    t = torch.where(first.valid, first.time, 1.0)
    bounce = rng.normal(size=(n, 3))
    bounce = torch.tensor(bounce / np.linalg.norm(bounce, axis=1, keepdims=True),
                          dtype=torch.float32, device=dev)
    half = torch.arange(n, device=dev) % 2 == 1
    o2 = torch.where(half[:, None], ray.at(t).to_array(), ray.origin.to_array())
    d2 = torch.where(half[:, None], bounce, ray.dir.to_array())
    ray = Ray(Vec3.from_array(o2), Vec3.from_array(d2))

    before = tracing.LAUNCHES["prim_closest_hit"]
    got = ph.prim_closest_hit(prims, ray, scene.t_min)
    assert tracing.LAUNCHES["prim_closest_hit"] == before + 1
    ref = ph.prim_closest_hit_plain(prims, ray, scene.t_min)
    same = (torch.isfinite(got.time) == torch.isfinite(ref.time)) & (got.material == ref.material)
    assert float(same.float().mean()) >= 0.9999
    hit = same & torch.isfinite(ref.time)
    assert 0.2 < float(hit.float().mean()) < 1.0
    torch.testing.assert_close(got.time[hit], ref.time[hit], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got.normal.to_array()[hit], ref.normal.to_array()[hit],
                               rtol=0.0, atol=1e-6)
    assert bool((got.material[~torch.isfinite(got.time)] == -1).all())

    limit = torch.tensor(np.where(rng.random(n) < 0.1, -1.0, rng.uniform(0, 10, n)),
                         dtype=torch.float32, device=dev)
    before = tracing.LAUNCHES["prim_any_hit"]
    occ = ph.prim_any_hit(prims, ray, scene.t_min, limit)
    assert tracing.LAUNCHES["prim_any_hit"] == before + 1
    occ_ref = ph.prim_any_hit_plain(prims, ray, scene.t_min, limit)
    assert 0.05 < float(occ_ref.float().mean()) < 0.95
    assert float((occ == occ_ref).float().mean()) >= 0.9999
    assert not bool(occ[limit <= scene.t_min].any())


@pytest.mark.cuda
def test_a_span_encloses_its_kernel_on_card():
    """The spans (`rpt_tpu_torch.tracing`) and the profiler's device events
    share one clock: a span around one K-prim launch and a synchronize
    encloses that kernel's device interval as the profiler reports it, and
    its launch delta is the one launch. Prints the offsets (span start to
    kernel start, kernel end to span end) in microseconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from rpt_tpu_torch.ops import prim_hit as ph
    from rpt_tpu_torch.ray import Ray
    from rpt_tpu_torch.vec import Vec3

    scene = _prim_scene("cubes")
    rng = np.random.default_rng(3)
    o = rng.normal(size=(16384, 3))
    o = 8.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-2, 2, o.shape) - o
    ray = Ray(Vec3.from_array(o, "cuda"),
              Vec3.from_array(d / np.linalg.norm(d, axis=1, keepdims=True), "cuda"))
    ph.prim_closest_hit(scene.prim_rows, ray, scene.t_min)
    torch.cuda.synchronize()
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with tracing.span("probe"):
                ph.prim_closest_hit(scene.prim_rows, ray, scene.t_min)
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda and "prim_closest_hit_kernel" in e.name())
    probes = [s for s in tracing.spans() if s.name == "probe"]
    tracing.clear()
    assert len(kernels) == len(probes) == 5
    for (k0, k1), span in zip(kernels, probes):
        print(f"span start to kernel start {(k0 - span.start_ns) / 1e3:.3f} us, kernel end to "
              f"span end {(span.end_ns - k1) / 1e3:.3f} us, kernel {(k1 - k0) / 1e3:.3f} us")
        assert span.start_ns <= k0 <= k1 <= span.end_ns
        assert span.launches == {"prim_closest_hit": 1}
