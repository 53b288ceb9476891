"""K-estimate (`csrc/photon_estimate.cu`, wrappers in
`ops/photon_estimate.py`): the photon map's estimates at the camera's
hits. On the CPU: the parameter block against the kernel's layout, the
routing (CPU lanes take the chains of torch ops, `surface_plain` and
`point_plain`; CUDA lanes take the kernel), a call's three launches under
their own names with the spans of the chain, the free flight's keys
flattened as the chain draws them, and the refusal of a medium of bare
callables. On the card: the kernel against the chains run on the same
CUDA tensors, with `torch.equal` on every lane's colour: the skybox's
wavefront (both branches and misses), the lampshade's point-beam surface
estimate at k = 20, a photon map with no medium, Henyey-Greenstein and
glowing-fog media with every material kind, no recheck, ragged lane
counts, k from 20 to 128; and a render's spans.

This file imports neither jax nor rpt_tpu, so the card's tests also run on
a GPU machine without JAX (`tests/conftest.py` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_estimate.py
"""

import collections
import ctypes
import inspect
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rpt_tpu_torch as rpt
from rpt_tpu_torch import intersect, sampling, tracing
from rpt_tpu_torch.accel import knn
from rpt_tpu_torch.integrators import photon as tph
from rpt_tpu_torch.medium import GLOW_SPLIT_Y, SAMPLE_D_TAG, Medium
from rpt_tpu_torch.ops import _build, threefry
from rpt_tpu_torch.ops import photon_estimate as pe
from rpt_tpu_torch.ops import photon_shoot as ks
from rpt_tpu_torch.ray import Hit, Ray
from rpt_tpu_torch.renderer import _photon_pass, camera_wavefront
from rpt_tpu_torch.vec import Vec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_photon_map as tpm  # noqa: E402
import torch_skybox_photons as tsky  # noqa: E402
import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402

NAMES = ("estimate_prep", "estimate_pairs", "estimate_finish")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"


def _lampshade(dev, medium="iso", extra=()):
    """The lampshade's renderer (`examples/torch_volumetric_beamphoton_lampshade.py`)
    on ``dev`` with ``medium`` (the example's fog, a `Medium`, or None) and
    the ``extra`` objects added."""
    scene = tlamp.build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), tlamp.watts))
    for obj in extra:
        scene.add(obj)
    if medium == "iso":
        medium = Medium.homogeneous_isotropic(tlamp.absorb, tlamp.scat)
    if medium is not None:
        scene.add(medium)
    return rpt.Renderer(scene, tlamp.camera(), device=dev)


def _map(r, photons, seed, kind=tph.PHOTON_MAP):
    """The scene of ``r`` and a photon map of ``photons`` photons shot from
    ``seed``."""
    scene = r.compiled
    shot = tph.shoot_photons_device(scene, scene.tables, sampling.key(seed, scene.device),
                                    photons, 3.0)
    return scene, tph.build_photon_map(scene, scene.tables, shot.surface, shot.volume, kind, 20,
                                       20, np.random.default_rng(0))


def _wavefront(r, scene, size, seed, lanes=None):
    """Sample 0's camera wavefront at ``size``^2 (the first ``lanes`` of
    it): the rays, the estimate's keys (fold 4 of the sample's, a
    `sampling.KeyPath`) and the closest hits."""
    ray, keys = camera_wavefront(scene, r.camera, size, size,
                                 sampling.key(seed, scene.device), 0)
    sl = slice(0, lanes)
    ray = Ray(ray.origin[sl], ray.dir[sl])
    return ray, sampling.fold(keys, 4)[sl], intersect.closest_hit(scene, scene.tables, ray)


def _branches(medium, ray, hit, keys):
    """The point query's lanes by branch: (in the medium, on a surface,
    missing everything)."""
    d, _, _ = medium.sample_d(ray, sampling.key_path(keys).fold(pe.FLIGHT_TAG))
    vol = ~hit.valid | (d < hit.time)
    return int(vol.sum()), int((~vol).sum()), int((~hit.valid).sum())


def _diff(label, a, b) -> str:
    bad = (a != b) & ~(a.isnan() & b.isnan())
    lanes = bad.any(dim=1).nonzero().flatten()
    first = int(lanes[0]) if lanes.numel() else -1
    rel = ((a - b).abs() / b.abs().clamp(min=1e-30))[bad]
    return (f"{label}: {lanes.numel()} of {a.shape[0]} lanes differ (largest relative gap "
            f"{float(rel.max()) if rel.numel() else 0.0:.3e}); first lane {first}: "
            f"{a[first].tolist()} against {b[first].tolist()}")


def _expect_equal(label, got: Vec3, want: Vec3):
    a, b = got.to_array(), want.to_array()
    assert a.shape == b.shape and torch.equal(a, b), _diff(label, a, b)


def _args(scene, pmap, ray, hit, k, occlusion):
    return scene, scene.tables, pmap, ray, hit, k, occlusion, tph.knn_query, intersect.occluded


def _compare_surface(label, scene, pmap, ray, hit, k, occlusion=True) -> Vec3:
    args = _args(scene, pmap, ray, hit, k, occlusion)
    got = pe.surface(*args)
    _expect_equal(label, got, pe.surface_plain(*args))
    return got


def _compare_point(label, scene, pmap, ray, hit, keys, k, kv, occlusion=True) -> Vec3:
    medium = scene.media[0]
    args = (scene, scene.tables, pmap, medium, ray, hit, keys, k, kv, occlusion, tph.knn_query,
            intersect.occluded)
    got = pe.point(*args)
    _expect_equal(label, got, pe.point_plain(*args))
    return got


# ---------------------------------------------------------------------------
# CPU


@pytest.fixture(scope="module")
def lampshade_cpu():
    """The lampshade in its fog on the CPU with a 3,000-photon map and
    sample 0's 16x16 wavefront."""
    r = _lampshade("cpu")
    scene, pmap = _map(r, 3_000, 11)
    assert pmap.surface_grid.n > 100 and pmap.volume_grid.n > 100
    return (r, scene, pmap, *_wavefront(r, scene, 16, 12))


def test_params_match_the_kernel():
    """`_EstimateParams` has the layout that `csrc/photon_estimate.cu` pins
    with its static_asserts, the medium's fields are `_ShootParams`' (one
    `_medium_constants` writes both), the three entry points take it by
    reference, and each launches under its own name."""
    with open(os.path.join(_build.CSRC_DIR, "photon_estimate.cu")) as f:
        src = f.read()
    pinned = dict(re.findall(r"offsetof\(EstimateParams, (\w+)\) == (\d+)", src))
    assert len(pinned) >= 15
    assert {k: int(v) for k, v in pinned.items()} == {
        name: getattr(pe._EstimateParams, name).offset for name in pinned}
    assert int(re.search(r"sizeof\(EstimateParams\) == (\d+)", src).group(1)) == \
        ctypes.sizeof(pe._EstimateParams)
    assert re.search(rf"constexpr int kRow = {tph.PHOTON_ROW};", src)
    assert re.search(rf"constexpr int kMaxK = {knn.MAX_K};", src)
    assert re.search(rf"constexpr int kMaxTags = {threefry.MAX_TAGS};", src)
    shoot = dict(ks._ShootParams._fields_)
    medium = [name for name, _ in pe._EstimateParams._fields_][
        [name for name, _ in pe._EstimateParams._fields_].index("medium"):]
    assert medium == [name for name, _ in ks._ShootParams._fields_][-len(medium):]
    assert all(dict(pe._EstimateParams._fields_)[name] == shoot[name] for name in medium)
    source = inspect.getsource(pe)
    for name in NAMES:
        entry = f"rpt_{name}"
        assert re.search(rf'extern "C" int {entry}\(const EstimateParams\* params, '
                         r'void\* stream\)', src)
        assert _build._SIGNATURES[entry] == [ctypes.c_void_p, ctypes.c_void_p]
        assert f'_build.launch("{name}", "{entry}", ' in source
    assert '#include "photon_common.cuh"' in src and '#include "threefry.cuh"' in src


def test_cpu_lanes_take_the_chains_and_launch_nothing(monkeypatch, lampshade_cpu):
    """CPU lanes: the integrator's two estimates are the chains'
    (`surface_plain`, `point_plain`) bit for bit, never build or reach the
    kernel library, and launch nothing."""
    r, scene, pmap, ray, keys, hit = lampshade_cpu
    medium = scene.media[0]
    want_s = pe.surface_plain(*_args(scene, pmap, ray, hit, 20, True))
    want_p = pe.point_plain(scene, scene.tables, pmap, medium, ray, hit, keys, 20, 20, True,
                            tph.knn_query, intersect.occluded)

    def no_card(*a, **k):
        raise AssertionError("CPU lanes reached the kernel")

    monkeypatch.setattr(_build, "library", no_card)
    monkeypatch.setattr(pe, "surface", no_card)
    monkeypatch.setattr(pe, "point", no_card)
    before = tracing.LAUNCHES.copy()
    _expect_equal("surface", tph.surface_estimate(scene, scene.tables, pmap, ray, hit, 20),
                  want_s)
    _expect_equal("point", tph.volume_estimate_point(scene, scene.tables, pmap, medium, ray, hit,
                                                     keys, 20, 20), want_p)
    assert tracing.LAUNCHES == before
    lanes = _branches(medium, ray, hit, keys)
    assert min(lanes[:2]) > 0 and float(want_p.to_array().abs().sum()) > 0


@pytest.mark.parametrize("medium", ["iso", "hg", "bare"])
def test_card_lanes_take_the_kernel_whatever_their_medium(monkeypatch, medium):
    """The route is the lanes' device alone: lanes on the card go to
    `surface` and `point` with any medium (the wrapper refuses bare
    callables itself), never to the chains. Here stand-ins report "cuda"."""
    calls = []
    for name in ("surface", "point"):
        monkeypatch.setattr(pe, name, lambda *a, _n=name: calls.append((_n, a)) or _n)
    for name in ("surface_plain", "point_plain"):
        monkeypatch.setattr(pe, name, lambda *a: pytest.fail("a card lane took the chain"))
    card = SimpleNamespace(device=torch.device("cuda"), shape=(64,))
    ray = Ray(Vec3(card, card, card), Vec3(card, card, card))
    med = {"iso": Medium.homogeneous_isotropic(1e-4, 1e-3),
           "hg": Medium.henyey_greenstein(1e-4, 1e-3, 0.6),
           "bare": Medium(*[getattr(Medium.homogeneous_isotropic(1e-4, 1e-3), f) for f in
                            ("absorption", "scattering", "emission", "color", "phase",
                             "sample_ph")])}[medium]
    assert tph.surface_estimate("scene", "tables", "pmap", ray, "hit", 20, False) == "surface"
    assert tph.volume_estimate_point("scene", "tables", "pmap", med, ray, "hit", "keys", 50,
                                     30) == "point"
    assert [c[0] for c in calls] == ["surface", "point"]
    assert calls[0][1][5:9] == (20, False, tph.knn_query, intersect.occluded)
    assert calls[1][1][3] is med and calls[1][1][7:12] == (50, 30, True, tph.knn_query,
                                                            intersect.occluded)


def _stub_library(monkeypatch):
    """The kernel library replaced by entry points that record a copy of
    the parameter block each call reads, and the card's guard lifted, so a
    call runs its host side on CPU tensors."""
    seen = []

    def entry(name):
        def launch(params, stream):
            seen.append((name, pe._EstimateParams.from_buffer_copy(bytes(params._obj))))
            return 0
        return launch

    lib = SimpleNamespace(**{f"rpt_{n}": entry(n) for n in NAMES})
    monkeypatch.setattr(_build, "library", lambda: SimpleNamespace(lib=lib))
    monkeypatch.setattr(_build, "on_card", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(tracing, "LAUNCHES", collections.Counter())
    return seen


def test_a_call_launches_its_three_kernels_in_the_chains_spans(monkeypatch, lampshade_cpu):
    """A point query's call: prep, then the volume and the surface gathers
    in their spans, then pairs, the recheck in its span, then finish, each
    launch counted under its wrapper's name; the parameter block holds the
    lanes, the gathers' answers and the recheck rays each kernel reads. A
    surface estimate without the recheck launches no pairs."""
    r, scene, pmap, ray, keys, hit = lampshade_cpu
    medium = scene.media[0]
    seen = _stub_library(monkeypatch)
    gathers, rechecks = [], []

    def gather(grid, queries, k):
        gathers.append((grid, queries.data_ptr(), k))
        return tph.knn_query(grid, queries, k)

    def occluded(scene_, tables, sray, limit):
        rechecks.append((sray, limit))
        return torch.zeros(limit.shape, dtype=torch.bool)

    n = ray.origin.x.shape[0]
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.span("photon.estimate"):
                pe.point(scene, scene.tables, pmap, medium, ray, hit, keys, 20, 30, True, gather,
                         occluded)
        spans = tracing.spans()
    finally:
        tracing.clear()
    (est,) = [s for s in spans if s.name == "photon.estimate"]
    kids = sorted((s for s in spans if s.parent == est.id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["photon.gather_volume", "photon.gather", "photon.occlusion"]
    assert est.launches == dict.fromkeys(NAMES, 1) and tracing.LAUNCHES == est.launches
    assert [name for name, _ in seen] == list(NAMES)
    prep, pairs, finish = (p for _, p in seen)
    assert (prep.n, prep.k, prep.kv, prep.point, prep.volume, prep.surface) == (n, 20, 30, 1, 1, 1)
    assert [g[0] for g in gathers] == [pmap.volume_grid, pmap.surface_grid]
    assert (gathers[0][1], gathers[0][2]) == (prep.v_query, 30)
    assert (gathers[1][1], gathers[1][2]) == (prep.s_query, 20)
    assert prep.s_idx is None and prep.recheck == 0
    assert pairs.s_idx and pairs.v_idx and pairs.recheck == 1 and pairs.occluded is None
    assert pairs.shadow_scale == np.float32(1.0 - scene.shadow_eps)
    (sray, limit), = rechecks
    m = n * 20
    assert sray.origin.x.data_ptr() == pairs.shadow and limit.data_ptr() == pairs.shadow + 24 * m
    assert finish.occluded and prep.ext == np.float32(tlamp.absorb) + np.float32(tlamp.scat)
    assert prep.medium == medium.preset.kind and tuple(prep.color) == medium.preset.color

    seen.clear()
    out = pe.surface(scene, scene.tables, pmap, ray, hit, 20, False, gather, occluded)
    assert [name for name, _ in seen] == ["estimate_prep", "estimate_finish"]
    assert seen[0][1].point == 0 and seen[0][1].recheck == 0 and len(rechecks) == 1
    assert out.x.shape == (n,)


def test_the_flight_keys_are_the_chains(lampshade_cpu):
    """The keys the prep kernel folds and draws, flattened from the
    renderer's `KeyPath` (a key, the pixel ids, the sample's tags, a slice)
    and from a key tensor, give `medium.sample_d`'s uniform word for word
    (K-rng's draw form lane by lane, `threefry.draw_flat_plain`)."""
    r, scene, pmap, ray, keys, hit = lampshade_cpu
    n = ray.origin.x.shape[0]
    for lane_keys in (keys, keys.keys(), sampling.keys_for(sampling.key(9), n)):
        flat = pe._flight_keys(pe._EstimateParams(), lane_keys, n)
        chain = sampling.uniform(sampling.fold(
            sampling.key_path(lane_keys).fold(pe.FLIGHT_TAG), SAMPLE_D_TAG))
        assert torch.equal(threefry.draw_flat_plain(flat)[0][0], chain)


def test_a_medium_without_a_preset_is_refused():
    """The kernel takes a preset's medium: one of bare callables is refused
    first, whatever the lanes' device; a preset's on CPU lanes is refused
    for the device."""
    iso = Medium.homogeneous_isotropic(1e-4, 1e-3)
    bare = Medium(iso.absorption, iso.scattering, iso.emission, iso.color, iso.phase,
                  iso.sample_ph, iso.phase_const)
    ray = Ray(Vec3.zeros(4), Vec3.ones(4))
    pmap = SimpleNamespace(surface_grid=SimpleNamespace(n=10), volume_grid=None)
    with pytest.raises(ValueError, match="no preset"):
        pe.point(None, None, pmap, bare, ray, Hit.none((4,)), None, 20, 20, True, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        pe.point(None, None, pmap, iso, ray, Hit.none((4,)), None, 20, 20, True, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        pe.surface(None, None, pmap, ray, Hit.none((4,)), 20, True, None, None)


# ---------------------------------------------------------------------------
# On the card: the kernel against the chains, bit for bit


@pytest.mark.cuda
def test_kernel_equals_the_chain_on_a_skybox_wavefront():
    """The skybox cell's point query at k = 50 / 50: a 16,384-lane
    wavefront (128^2) of the open foggy box with a 500,000-photon map,
    lanes in the fog, on surfaces and through the opening; then a ragged
    1,001 lanes of it."""
    dev = _card()
    r = tsky.renderer(dev)
    scene, pmap = _map(r, 500_000, 21)
    ray, keys, hit = _wavefront(r, scene, 128, 22)
    vol, surf, miss = _branches(scene.media[0], ray, hit, keys)
    assert vol > 1000 and surf > 1000 and miss >= 10, (vol, surf, miss)
    got = _compare_point("skybox 16,384 lanes", scene, pmap, ray, hit, keys, 50, 50)
    assert bool(torch.isfinite(got.to_array()).all()) and float(got.to_array().sum()) > 0
    ray, keys, hit = _wavefront(r, scene, 128, 23, lanes=1_001)
    _compare_point("skybox 1,001 lanes", scene, pmap, ray, hit, keys, 50, 50)


@pytest.mark.cuda
def test_kernel_equals_the_chain_on_the_lampshade_surface_estimate():
    """The beam cell's surface estimate: the point-beam map of the
    lampshade in its fog (300,000 photons), k = 20 with the recheck, on a
    16,384-lane wavefront."""
    dev = _card()
    r = _lampshade(dev)
    scene, pmap = _map(r, 300_000, 31, tph.POINT_BEAM)
    ray, _, hit = _wavefront(r, scene, 128, 32)
    got = _compare_surface("lampshade k=20", scene, pmap, ray, hit, 20)
    assert float(got.to_array().sum()) > 0


@pytest.mark.cuda
def test_kernel_equals_the_chain_with_no_medium():
    """`examples/torch_photon_map.py`'s scene, no medium: the surface
    estimate at k = 50 over a 300,000-photon map."""
    dev = _card()
    r = tpm.renderer(dev)
    scene, pmap = _map(r, 300_000, 41)
    assert not scene.media and pmap.volume_grid.n == 0
    ray, _, hit = _wavefront(r, scene, 128, 42)
    _compare_surface("photon_map.py k=50", scene, pmap, ray, hit, 50)


def _lobes():
    """A mirror sphere, a glass sphere, a Phong sphere and a Phong cube in
    the lampshade's box."""
    def sphere(rad, at):
        return rpt.sphere().scale((rad, rad, rad)).translate(at)

    return [
        rpt.Object(sphere(80.0, (150.0, 80.0, 150.0))).material(rpt.Material.mirror()),
        rpt.Object(sphere(90.0, (400.0, 90.0, 200.0))).material(rpt.Material.transmissive(1.5)),
        rpt.Object(sphere(70.0, (280.0, 300.0, 350.0))).material(
            rpt.Material.specular(rpt.hex_color(0x99CCEE), 20.0)),
        rpt.Object(rpt.cube().scale((60.0, 60.0, 60.0)).translate((120.0, 30.0, 420.0))).material(
            rpt.Material.metallic(rpt.hex_color(0xEEBB66), 3.5)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("medium", ["hg+", "hg-", "glow"])
def test_kernel_equals_the_chain_in_each_medium(medium):
    """The point query in Henyey-Greenstein media (forward and backward
    lobes: the phase of each photon's direction) and in the glowing fog
    (its colour split at y = 250), thin enough that about 40% of the lanes
    scatter before their hit, with a mirror, glass and Phong lobes in the
    box, at k = 20 / 30 over a 300,000-photon map."""
    dev = _card()
    med = {"hg+": Medium.henyey_greenstein(1e-5, 4e-4, 0.6),
           "hg-": Medium.henyey_greenstein(1e-5, 4e-4, -0.45),
           "glow": Medium.colored_glowing_fog(1e-5, 4e-4)}[medium]
    r = _lampshade(dev, med, _lobes())
    scene, pmap = _map(r, 300_000, 51)
    assert set(scene.tables["materials"].kind.tolist()) == {0, 1, 2, 3}
    ray, keys, hit = _wavefront(r, scene, 128, 52)
    vol, surf, _ = _branches(med, ray, hit, keys)
    assert vol > 1000 and surf > 1000, (vol, surf)
    if medium == "glow":
        ys = pmap.volume[:, 1]
        assert bool((ys > GLOW_SPLIT_Y).any()) and bool((ys <= GLOW_SPLIT_Y).any())
    _compare_point(f"lampshade in {medium}", scene, pmap, ray, hit, keys, 20, 30)


@pytest.mark.cuda
def test_kernel_equals_the_chain_without_the_recheck():
    """``occlusion_check=False``: every valid answer counts; the point
    query and the surface estimate, no pairs launched."""
    dev = _card()
    r = tsky.renderer(dev)
    scene, pmap = _map(r, 300_000, 61)
    ray, keys, hit = _wavefront(r, scene, 64, 62)
    before = tracing.LAUNCHES["estimate_pairs"]
    _compare_point("skybox, no recheck", scene, pmap, ray, hit, keys, 50, 50, occlusion=False)
    _compare_surface("skybox surface, no recheck", scene, pmap, ray, hit, 50, occlusion=False)
    assert tracing.LAUNCHES["estimate_pairs"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 50, 100, 128])
def test_kernel_equals_the_chain_at_each_k(k):
    """The skybox's point query with both gathers at k, 3,001 lanes."""
    dev = _card()
    r = tsky.renderer(dev)
    scene, pmap = _map(r, 300_000, 71)
    ray, keys, hit = _wavefront(r, scene, 64, 72, lanes=3_001)
    _compare_point(f"skybox k={k}", scene, pmap, ray, hit, keys, k, k)
    _compare_surface(f"skybox surface k={k}", scene, pmap, ray, hit, k)


@pytest.mark.cuda
def test_an_empty_volume_cloud():
    """A map whose volume cloud is empty: lanes in the medium read zero,
    lanes on surfaces their attenuated surface estimate, as the chain."""
    dev = _card()
    r = tsky.renderer(dev)
    scene, pmap = _map(r, 200_000, 81)
    empty = tph.build_photon_map(scene, scene.tables, pmap.surface, pmap.surface[:0],
                                 tph.PHOTON_MAP, 20, 20, np.random.default_rng(0))
    ray, keys, hit = _wavefront(r, scene, 64, 82)
    got = _compare_point("no volume photons", scene, empty, ray, hit, keys, 50, 50)
    assert float(got.to_array().sum()) > 0


@pytest.mark.cuda
def test_every_estimate_of_a_render_takes_the_kernel():
    """A 64^2, 2-sample pass of the skybox on the card: each `photon.estimate`
    span holds its closest hit, the two gathers and the recheck, and
    launches prep, pairs and finish once each."""
    dev = _card()
    r = tsky.renderer(dev)
    scene, pmap = _map(r, 200_000, 91)
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _photon_pass(scene, r.camera, 64, 64, pmap, sampling.key(92, dev), 2, 50, 50, True)
        spans = tracing.spans()
    finally:
        tracing.clear()
    estimates = [s for s in spans if s.name == "photon.estimate"]
    assert len(estimates) == 2
    for est in estimates:
        kids = sorted((s for s in spans if s.parent == est.id), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["intersect.closest", "photon.gather_volume",
                                          "photon.gather", "photon.occlusion"]
        assert all(est.launches.get(name) == 1 for name in NAMES), est.launches
