"""K-dense (`csrc/dense_tri_hit.cu`, wrappers in `ops/dense_tri_hit.py`):
the closest-hit and any-hit tests of a mesh of at most `DENSE_TRI_ROWS`
leaf rows. On the CPU: the routing (CPU rays take the chain of torch ops,
`dense_tri_hit_plain`; a mesh above the row limit takes the traversal),
`skip` and the limits, the wrappers' checks, and the parameter block
against the kernel's layout. On the card: the kernel bit for bit against
`dense_tri_hit_plain` run on the same CUDA tensors.

This file imports neither jax nor rpt_tpu, so the card's tests also run on
a GPU machine without JAX (`tests/conftest.py` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_dense.py
"""

import ctypes
import math
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rpt_tpu_torch import intersect, tracing
from rpt_tpu_torch.accel.bvh import build_bvh, pack_bvh
from rpt_tpu_torch.intersect import BVHTables, dense_tri_hit_plain
from rpt_tpu_torch.ops import _build
from rpt_tpu_torch.ops import bvh_traverse as k12
from rpt_tpu_torch.ops import dense_tri_hit as kd
from rpt_tpu_torch.ray import Hit, Ray
from rpt_tpu_torch.vec import Vec3

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
T_MIN = 2e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"


def _tables(tris, rows, dev="cpu", mats=None) -> BVHTables:
    """Tables of ``rows`` leaf rows filled in order from ``tris`` (T, 3, 3),
    the slots past the last triangle empty (id -1); each triangle's vertex
    normals are its vertices, its material its index plus 1. No nodes: only
    the dense test reads these."""
    tris = np.asarray(tris, np.float32)
    leaves = np.zeros((rows, intersect.LEAF_ROW), np.float32)
    leaves[:, 72:] = -1.0
    for k, (a, b, c) in enumerate(tris):
        r, s = divmod(k, intersect.LEAF_TRIS)
        for comp, value in enumerate((*a, *(b - a), *(c - a), k)):
            leaves[r, comp * 8 + s] = value
    shade = np.zeros((len(tris), intersect.SHADE_ROW), np.float32)
    shade[:, :9] = tris.reshape(-1, 9)
    shade[:, 9] = np.arange(1, len(tris) + 1) if mats is None else mats
    empty = torch.zeros((0, intersect.NODE_ROW))
    return BVHTables(empty.to(dev), torch.from_numpy(leaves).to(dev),
                     torch.from_numpy(shade).to(dev))


def _packed(n, seed, dev="cpu") -> BVHTables:
    """A soup of ``n`` triangles through the SAH builder and `pack_bvh`."""
    v = _soup(n, seed)
    *tables, depth = pack_bvh(build_bvh(v.min(1), v.max(1)), v, v, np.zeros(n, np.int32))
    return BVHTables(*(torch.from_numpy(a).to(dev) for a in tables), depth)


def _soup(n, seed):
    """``n`` random triangles in [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, (n, 1, 3))
    return centre + rng.normal(0, 0.3, (n, 3, 3))


def _rays(n, seed, dev="cpu", tris=None):
    """Rays from a shell toward the unit box or, given ``tris``, toward
    points near random points of them."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    if tris is None:
        target = rng.uniform(-0.8, 0.8, (n, 3))
    else:
        w = rng.dirichlet(np.ones(3), n)[:, :, None]
        target = (w * tris[rng.integers(0, len(tris), n)]).sum(1) + rng.normal(0, 0.05, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(Vec3.from_array(o, dev), Vec3.from_array(d, dev)), rng


def _restart(bvh, ray, rng):
    """Half of the rays restarted from their first hit in a random
    direction (their origins on a triangle's plane)."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    first = dense_tri_hit_plain(bvh, ray, T_MIN, Hit.none((n,), dev))
    t = torch.where(first.valid, first.time, 1.0)
    d = rng.normal(size=(n, 3))
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32,
                     device=dev)
    half = (torch.arange(n, device=dev) % 2 == 1)[:, None]
    o = torch.where(half, ray.at(t).to_array(), ray.origin.to_array())
    return Ray(Vec3.from_array(o), Vec3.from_array(torch.where(half, d, ray.dir.to_array())))


def _best(n, rng, dev):
    """An incoming hit (K-prim's): a third of the lanes at a finite time."""
    t = np.where(rng.random(n) < 0.3, rng.uniform(0.5, 4.0, n), np.inf)
    return Hit(torch.tensor(t, dtype=torch.float32, device=dev),
               Vec3.from_array(rng.normal(size=(n, 3)), dev),
               torch.tensor(rng.integers(-1, 6, n), dtype=torch.int32, device=dev))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_hit(a: Hit, b: Hit) -> bool:
    return (torch.equal(_bits(a.time), _bits(b.time)) and torch.equal(a.material, b.material)
            and all(torch.equal(_bits(getattr(a.normal, c)), _bits(getattr(b.normal, c)))
                    for c in "xyz"))


# ---------------------------------------------------------------------------
# CPU


def test_cpu_rays_take_the_chain_and_launch_nothing():
    """CPU rays: `bvh_closest_hit` and `bvh_any_hit` on a dense mesh give
    the chain's bits (`dense_tri_hit_plain`), the any-hit entry its
    ``time < limit`` with the ``skip`` lanes False, and nothing launches."""
    soup = _soup(21, 1)
    bvh = _tables(soup, 3)
    ray, rng = _rays(700, 2, tris=soup)
    ray = _restart(bvh, ray, rng)
    best = _best(700, rng, "cpu")
    before = (kd.dense_closest_hit.launches, kd.dense_any_hit.launches)
    got = intersect.bvh_closest_hit(bvh, ray, T_MIN, best)
    ref = dense_tri_hit_plain(bvh, ray, T_MIN, best)
    assert _same_hit(got, ref)
    improved = ref.time < best.time
    assert 0.1 < float(improved.float().mean()) < 0.9
    assert bool((ref.material[improved] >= 1).all())
    kept = Hit(best.time[~improved], best.normal[~improved], best.material[~improved])
    assert _same_hit(Hit(ref.time[~improved], ref.normal[~improved], ref.material[~improved]),
                     kept)

    limit = torch.tensor(np.where(rng.random(700) < 0.1, -1.0, rng.uniform(0, 5, 700)),
                         dtype=torch.float32)
    skip = torch.tensor(rng.random(700) < 0.2)
    occ = intersect.bvh_any_hit(bvh, ray, T_MIN, limit, skip=skip)
    chain = dense_tri_hit_plain(bvh, ray, T_MIN, Hit.none((700,))).time < limit
    assert torch.equal(occ, chain & ~skip)
    assert torch.equal(kd.dense_any_hit_plain(bvh, ray, T_MIN, limit), chain)
    assert not bool(occ[skip | (limit <= T_MIN)].any()) and 0.05 < float(occ.float().mean())
    assert (kd.dense_closest_hit.launches, kd.dense_any_hit.launches) == before


def test_rows_above_the_limit_take_the_traversal(monkeypatch):
    """The row count alone routes a mesh: at most `DENSE_TRI_ROWS` rows take
    the dense wrappers, more the traversal wrappers (K1/K2)."""
    seen = []
    for name in ("dense_closest_hit", "dense_any_hit"):
        real = getattr(kd, name)
        monkeypatch.setattr(intersect.dense, name,
                            lambda *a, _n=name, _f=real, **k: seen.append(_n) or _f(*a, **k))
    for name in ("bvh_closest_hit", "bvh_any_hit"):
        real = getattr(k12, name)
        monkeypatch.setattr(intersect.kernels, name,
                            lambda *a, _n=name, _f=real, **k: seen.append(_n) or _f(*a, **k))
    ray, _ = _rays(64, 3)
    small = _tables(_soup(64, 4), intersect.DENSE_TRI_ROWS)
    big = _packed(300, 5)
    assert big.leaves.shape[0] > intersect.DENSE_TRI_ROWS
    for bvh in (small, big):
        intersect.bvh_closest_hit(bvh, ray, T_MIN, Hit.none((64,)))
        intersect.bvh_any_hit(bvh, ray, T_MIN, 2.0)
    assert seen == ["dense_closest_hit", "dense_any_hit", "bvh_closest_hit", "bvh_any_hit"]


def test_wrappers_check_their_arguments():
    """The wrappers refuse what the kernel does not take, as K-prim's do:
    tables of another layout, type or row count, rays or tables on another
    device than the CPU or a card, and a limit or incoming hit of another
    type."""
    bvh = _tables(_soup(10, 6), 2)
    ray, _ = _rays(50, 7)
    none = Hit.none((50,))
    meta = BVHTables(bvh.nodes, bvh.leaves.to("meta"), bvh.shade.to("meta"))
    meta_ray = Ray(ray.origin.map(lambda c: c.to("meta")), ray.dir.map(lambda c: c.to("meta")))
    with pytest.raises(ValueError, match="unsupported device"):
        kd.dense_closest_hit(meta, meta_ray, T_MIN, Hit.none((50,), "meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kd.dense_any_hit(meta, meta_ray, T_MIN, 1.0)
    with pytest.raises(ValueError, match="the ray is on"):
        kd.dense_closest_hit(meta, ray, T_MIN, none)
    with pytest.raises(ValueError, match="the shade rows are on"):
        kd.dense_any_hit(BVHTables(bvh.nodes, bvh.leaves, bvh.shade.to("meta")), ray, T_MIN, 1.0)
    for bad in (bvh.leaves[:, :40], bvh.leaves.double(), bvh.leaves.t()):
        with pytest.raises(ValueError, match="leaves must be"):
            kd.dense_any_hit(BVHTables(bvh.nodes, bad, bvh.shade), ray, T_MIN, 1.0)
    with pytest.raises(ValueError, match="shade must be"):
        kd.dense_closest_hit(BVHTables(bvh.nodes, bvh.leaves, bvh.shade[:, :9]), ray, T_MIN, none)
    nine = _tables(_soup(70, 8), 9)
    with pytest.raises(ValueError, match="at most 8"):
        kd.dense_closest_hit(nine, ray, T_MIN, none)
    with pytest.raises(ValueError, match="float32"):
        kd.dense_closest_hit(bvh, Ray(ray.origin.map(torch.Tensor.double), ray.dir), T_MIN, none)
    # the card's lane inputs: a limit, the incoming hit's parts, the skip
    # mask (checked after the device dispatch, as K-prim's limit)
    cpu = torch.device("cpu")
    for what, x, dtype in (("limit", torch.ones(50, dtype=torch.float64), torch.float32),
                           ("best", torch.ones(50), torch.int32),
                           ("skip", torch.ones(50, dtype=torch.bool, device="meta"), torch.bool)):
        with pytest.raises(ValueError, match=f"{what} must be"):
            kd._lane_tensor("dense_any_hit", what, x, dtype, (50,), cpu)
    flat = kd._lane_tensor("dense_any_hit", "limit", 2.0, torch.float32, (50,), cpu)
    assert flat.shape == (50,) and flat.stride(0) == 0 and bool((flat == 2.0).all())


def test_params_struct_matches_the_kernel():
    """`_DenseParams` has the layout that `csrc/dense_tri_hit.cu` pins with
    its static_asserts, the two entry points take it by reference, its row
    widths and row limit are `intersect`'s, and the spans count both
    wrappers' launches."""
    with open(os.path.join(_build.CSRC_DIR, "dense_tri_hit.cu")) as f:
        src = f.read()
    pinned = dict(re.findall(r"offsetof\(DenseParams, (\w+)\) == (\d+)", src))
    assert len(pinned) >= 10 and {k: int(v) for k, v in pinned.items()} == {
        k: getattr(kd._DenseParams, k).offset for k in pinned}
    assert int(re.search(r"sizeof\(DenseParams\) == (\d+)", src).group(1)) == \
        ctypes.sizeof(kd._DenseParams)
    for name, value in (("kLeafTris", intersect.LEAF_TRIS), ("kLeafRow", intersect.LEAF_ROW),
                        ("kShadeRow", intersect.SHADE_ROW), ("kMaxRows", intersect.DENSE_TRI_ROWS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
    for name in ("rpt_dense_closest_hit", "rpt_dense_any_hit"):
        assert re.search(rf'extern "C" int {name}\(const DenseParams\* params, void\* stream\)',
                         src)
        assert _build._SIGNATURES[name] == [ctypes.c_void_p, ctypes.c_void_p]
        assert ("rpt_tpu_torch.ops.dense_tri_hit", name[4:]) in tracing.COUNTERS


# ---------------------------------------------------------------------------
# The card


def _check_closest(bvh, ray, t_min, best):
    before = kd.dense_closest_hit.launches
    got = kd.dense_closest_hit(bvh, ray, t_min, best)
    assert kd.dense_closest_hit.launches == before + 1
    ref = dense_tri_hit_plain(bvh, ray, t_min, best)
    assert _same_hit(got, ref)
    return ref


def _check_any(bvh, ray, t_min, limit, skip=None):
    before = kd.dense_any_hit.launches
    got = kd.dense_any_hit(bvh, ray, t_min, limit, skip)
    assert kd.dense_any_hit.launches == before + 1
    ref = kd.dense_any_hit_plain(bvh, ray, t_min, limit, skip)
    assert torch.equal(got, ref)
    return ref


def _capture(run):
    """The calls `intersect` makes to the dense wrappers while ``run()``
    renders: ``{name: [args, ...]}``, in call order."""
    real = intersect.dense
    calls = {"dense_closest_hit": [], "dense_any_hit": []}

    def recorder(name):
        def call(*args):
            calls[name].append(args)
            return getattr(real, name)(*args)
        return call

    intersect.dense = SimpleNamespace(**{name: recorder(name) for name in calls})
    try:
        run()
    finally:
        intersect.dense = real
    return calls


def _lampshade(module, **kwargs):
    sys.path.insert(0, EXAMPLES)
    try:
        return __import__(module).renderer("cuda", **kwargs)
    finally:
        sys.path.remove(EXAMPLES)


@pytest.mark.cuda
def test_dense_kernel_matches_the_chain_on_lampshade_wavefronts():
    """Every dense query of a volumetric path pass of the lampshade (camera
    rays, bounce levels, NEE shadow rays with limit -1 lanes, all with a
    `skip` mask) and of a point-beam render (the photon shoot's levels, the
    camera pass, the occlusion recheck) replayed through K-dense and the
    chain on the same CUDA tensors: bit-equal on every lane of every call,
    one launch a call."""
    _card()
    from rpt_tpu_torch import Buffer

    path = _lampshade("torch_volumetric_pathtrace_lampshade", size=48, sample=1)
    assert path.compiled.tables["bvh"].leaves.shape[0] <= intersect.DENSE_TRI_ROWS
    beam = _lampshade("torch_volumetric_beamphoton_lampshade", size=48, sample=1,
                      photons=100_000)
    captured = [_capture(lambda: path.sample(1, Buffer(48, 48, path.filter_))),
                _capture(lambda: beam.photon_point_query_beam_render(100_000))]
    for calls in captured:
        closest, anyhit = calls["dense_closest_hit"], calls["dense_any_hit"]
        assert len(closest) >= 3 and anyhit
        for bvh, ray, t_min, best in closest:
            _check_closest(bvh, ray, t_min, best)
        gated = skipped = 0
        for bvh, ray, t_min, limit, skip in anyhit:
            _check_any(bvh, ray, t_min, limit, skip)
            gated += int((torch.as_tensor(limit) <= t_min).sum())
            skipped += int(skip.sum())
        assert gated and skipped


@pytest.mark.cuda
def test_dense_kernel_edge_cases_on_card():
    """On a unit quad (two triangles sharing its diagonal) and a wall:
    rays straight down onto the diagonal (both triangles at the same t:
    the first slot wins), rays aimed at it from jittered origins (grazing
    the shared edge), origins one float32 step off the wall's plane, half
    of them grazing it (the on-plane guard), rays parallel to the quad and
    the wall, and NaN directions: bit-equal to the chain, closest hit and
    any hit."""
    dev = _card()
    quad = [[[0, 0, 0], [1, 0, 0], [1, 1, 0]], [[0, 0, 0], [1, 1, 0], [0, 1, 0]]]
    wall = [[[-2, -2, 3], [2, -2, 3], [2, 2, 3]], [[-2, -2, 3], [2, 2, 3], [-2, 2, 3]]]
    bvh = _tables(np.asarray(quad + wall, np.float64), 1, dev)
    rng = np.random.default_rng(11)
    n = 2048
    s = rng.uniform(0.05, 0.95, n).astype(np.float32)
    on_diag = np.stack([s, s, np.zeros(n, np.float32)], 1)
    below = np.stack([s, s, np.full(n, -2.0, np.float32)], 1)
    jitter = below + rng.normal(0, 0.3, (n, 3)) * [1, 1, 0]
    off = np.where(rng.random(n) < 0.5, np.inf, -np.inf)
    near_wall = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                          np.nextafter(np.float32(3.0), off.astype(np.float32))], 1)
    graze = rng.normal(size=(n, 3)) * np.where(rng.random((n, 1)) < 0.5, [1, 1, 1],
                                               [1, 1, 1e-4])
    parallel_o = np.stack([rng.uniform(-3, -2.5, n), rng.uniform(-1, 1, n),
                           rng.choice([0.0, 3.0], n)], 1)
    parallel_d = np.stack([np.ones(n), rng.normal(0, 0.2, n), np.zeros(n)], 1)
    o = np.concatenate([below, jitter, near_wall, parallel_o]).astype(np.float32)
    d = np.concatenate([np.tile([0.0, 0.0, 1.0], (n, 1)), on_diag - jitter, graze, parallel_d])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[7::53] = np.nan
    m = len(o)
    ray = Ray(Vec3.from_array(o, dev), Vec3.from_array(d, dev))
    ref = _check_closest(bvh, ray, T_MIN, Hit.none((m,), dev))
    _check_closest(bvh, ray, T_MIN, _best(m, rng, dev))
    # straight down onto the diagonal both triangles hit at t = 2 exactly:
    # every such lane takes the first
    tie = torch.tensor(np.arange(m) < n, device=dev) & ref.valid
    assert int(tie.sum()) > 0.95 * n and bool((ref.material[tie] == 1).all())
    assert bool((ref.time[tie] == 2.0).all())
    assert not bool(ref.valid[torch.tensor(np.isnan(d[:, 0]), device=dev)].any())
    # an origin one step off the wall never hits the wall it sits on
    assert not bool((ref.material[2 * n:3 * n] >= 3).any())
    limit = torch.tensor(np.where(rng.random(m) < 0.1, -1.0, rng.uniform(0, 8, m)),
                         dtype=torch.float32, device=dev)
    _check_any(bvh, ray, T_MIN, limit)
    _check_any(bvh, ray, T_MIN, limit, torch.tensor(rng.random(m) < 0.3, device=dev))
    _check_any(bvh, ray, T_MIN, math.inf)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, tris", [(1, 5), (8, 64), (8, 50)])
def test_dense_kernel_on_one_and_eight_rows(rows, tris):
    """A 1-row mesh with empty slots, a full 8-row mesh and an 8-row mesh
    with its last row partly empty, on 5003 random rays (no multiple of a
    block) and their restarts: bit-equal to the chain, one launch a call."""
    dev = _card()
    soup = _soup(tris, rows)
    bvh = _tables(soup, rows, dev)
    ray, rng = _rays(5003, rows + tris, dev, soup)
    ray = _restart(bvh, ray, rng)
    ref = _check_closest(bvh, ray, T_MIN, Hit.none((5003,), dev))
    assert 0.2 < float(ref.valid.float().mean()) < 1.0
    _check_closest(bvh, ray, T_MIN, _best(5003, rng, dev))
    limit = torch.tensor(np.where(rng.random(5003) < 0.1, -1.0, rng.uniform(0, 4, 5003)),
                         dtype=torch.float32, device=dev)
    occ = _check_any(bvh, ray, T_MIN, limit, torch.tensor(rng.random(5003) < 0.2, device=dev))
    assert 0.05 < float(occ.float().mean()) < 0.95
    _check_any(bvh, ray, T_MIN, 2.0)


@pytest.mark.cuda
def test_nine_rows_launch_the_traversal_on_card():
    """A mesh of more than `DENSE_TRI_ROWS` rows launches K1/K2 through
    `bvh_closest_hit`/`bvh_any_hit` and never K-dense; one of at most
    launches K-dense and never K1/K2."""
    dev = _card()
    big = _packed(300, 9, dev)
    assert big.leaves.shape[0] > intersect.DENSE_TRI_ROWS
    small = _tables(_soup(40, 10), 5, dev)
    ray, _ = _rays(2000, 12, dev)

    def launches():
        return (kd.dense_closest_hit.launches, kd.dense_any_hit.launches,
                k12.bvh_closest_hit.launches, k12.bvh_any_hit.launches)

    for bvh, expect in ((big, (0, 0, 1, 1)), (small, (1, 1, 0, 0))):
        before = launches()
        intersect.bvh_closest_hit(bvh, ray, T_MIN, Hit.none((2000,), dev))
        intersect.bvh_any_hit(bvh, ray, T_MIN, 2.0)
        assert tuple(b - a for a, b in zip(before, launches())) == expect
