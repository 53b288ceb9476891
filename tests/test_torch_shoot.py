"""K-shoot (`csrc/photon_shoot.cu`, wrappers in `ops/photon_shoot.py`):
the interaction of a photon shoot level. On the CPU: each medium preset's
constants (`medium.MediumPreset`) against what its callables compute, the
routing (CPU scenes take the chain of torch ops, `shoot_level_plain`;
scenes on the card take the kernel, which refuses a medium of bare
callables), the wrappers' refusals, and the parameter block
against the kernel's layout. On the card: the kernel level by level and
chunk by chunk against `shoot_level_plain` run on the same CUDA tensors,
with `torch.equal` on the surface rows, the volume rows, the survivors and
the dropped count.

This file imports neither jax nor rpt_tpu, so the card's tests also run on
a GPU machine without JAX (`tests/conftest.py` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_shoot.py
"""

import ctypes
import dataclasses
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

import rpt_tpu_torch as rpt
from rpt_tpu_torch import intersect, sampling, tracing
from rpt_tpu_torch.integrators import photon as tph
from rpt_tpu_torch.medium import (
    GLOW_SPLIT_Y, GLOWING, HENYEY_GREENSTEIN, ISOTROPIC, Medium, MediumPreset,
)
from rpt_tpu_torch.ops import _build
from rpt_tpu_torch.ops import photon_shoot as ks
from rpt_tpu_torch.ray import Hit, Ray
from rpt_tpu_torch.vec import Vec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_photon_map as tpm  # noqa: E402
import torch_skybox_photons as tsky  # noqa: E402
import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402

CHUNK = 1 << 19


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"


def _points(dev="cpu"):
    """Four points, two above the glowing fog's split and two below."""
    y = torch.tensor([0.0, GLOW_SPLIT_Y, GLOW_SPLIT_Y + 1.0, 548.0], device=dev)
    return Vec3(torch.ones_like(y), y, torch.ones_like(y))


# ---------------------------------------------------------------------------
# The presets' constants


@pytest.mark.parametrize("make, kind, phase_const, g", [
    (lambda: Medium.homogeneous_isotropic(1e-4, 1e-3), ISOTROPIC, sampling.INV_4PI, 0.0),
    (lambda: Medium.colored_glowing_fog(2e-4, 3e-3), GLOWING, 0.25 * math.pi, 0.0),
    (lambda: Medium.henyey_greenstein(5e-5, 3e-3, 0.6), HENYEY_GREENSTEIN, 0.0, 0.6),
    (lambda: Medium.henyey_greenstein(1e-3, 2e-3, -0.3, rpt.hex_color(0x336699)),
     HENYEY_GREENSTEIN, 0.0, -0.3),
])
def test_each_preset_records_what_its_callables_compute(make, kind, phase_const, g):
    """The preset's kind, coefficients, phase and colours are the numbers
    its callables return: the fields at points on both sides of the
    glowing fog's split, the isotropic phase, the asymmetry."""
    medium = make()
    pre = medium.preset
    assert isinstance(pre, MediumPreset) and (pre.kind, pre.g) == (kind, g)
    p = _points()
    assert torch.equal(medium.absorption(p), torch.full_like(p.x, pre.absorption))
    assert torch.equal(medium.scattering(p), torch.full_like(p.x, pre.scattering))
    col = medium.color(p)
    high = p.y > GLOW_SPLIT_Y
    for c, (a, b) in enumerate(zip(pre.color, pre.color_below)):
        want = torch.where(high, torch.full_like(p.x, a), torch.full_like(p.x, b))
        assert torch.equal((col.x, col.y, col.z)[c], want)
    if kind == GLOWING:
        assert pre.color != pre.color_below
    else:
        assert pre.color == pre.color_below
    wo = Vec3(*(torch.tensor([0.6, -0.8, 0.0, 0.0]) for _ in range(3))).normalize()
    if kind != HENYEY_GREENSTEIN:
        assert medium.phase_const == phase_const
        assert torch.equal(medium.phase(wo, wo), torch.full_like(wo.x, phase_const))
    else:
        assert medium.phase_const is None


def test_kernel_constants_round_as_the_chain():
    """The float32 constants the kernel takes are the chain's own values:
    the extinction, the roulette's quotient and the colours as the
    callables compute them in float32, the Henyey-Greenstein constants as
    its Python expressions round, and nothing for no medium."""
    p = _points()
    for medium in (Medium.homogeneous_isotropic(1e-4, 1e-3),
                   Medium.colored_glowing_fog(2e-4, 3e-3),
                   Medium.henyey_greenstein(5e-5, 3e-3, 0.6)):
        params = ks._ShootParams()
        ks._medium_constants(params, medium)
        ext = medium.extinction(p)
        assert torch.equal(torch.full_like(p.x, params.ext), ext)
        assert torch.equal(torch.full_like(p.x, params.rr), medium.scattering(p) / ext)
        assert params.medium == medium.preset.kind
        if medium.phase_const is not None:
            assert params.phase == params.pdf == np.float32(medium.phase_const)
        assert tuple(params.color) == medium.preset.color
        assert tuple(params.color_below) == medium.preset.color_below
    f32 = np.float32
    params = ks._ShootParams()
    ks._medium_constants(params, Medium.henyey_greenstein(5e-5, 3e-3, 0.6))
    assert (params.hg_invert, params.pdf) == (1, f32(sampling.INV_4PI))
    assert params.hg_inv_two_g == f32(1.0) / f32(1.2)
    assert params.hg_norm == f32(sampling.INV_4PI * (1.0 - 0.36))
    assert (params.hg_two_g, params.hg_one_plus_g2) == (f32(1.2), f32(1.36))
    ks._medium_constants(params, Medium.henyey_greenstein(5e-5, 3e-3, 1e-7))
    assert params.hg_invert == 0
    none = ks._ShootParams()
    ks._medium_constants(none, None)
    assert (none.medium, none.ext, none.rr) == (0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# The routing and the refusals


def _bare_medium():
    """A medium of the caller's own callables: no preset."""
    iso = Medium.homogeneous_isotropic(1e-4, 1e-3)
    return Medium(iso.absorption, iso.scattering, iso.emission, iso.color, iso.phase,
                  iso.sample_ph, iso.phase_const)


def _lampshade_scene(dev, medium="iso", extra=()):
    """The lampshade's scene (`examples/torch_volumetric_beamphoton_lampshade.py`)
    compiled on ``dev``, with ``medium`` (a preset's name, a `Medium`, or
    None) and the ``extra`` objects added."""
    scene = tlamp.build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), tlamp.watts))
    for obj in extra:
        scene.add(obj)
    if medium == "iso":
        medium = Medium.homogeneous_isotropic(tlamp.absorb, tlamp.scat)
    if medium is not None:
        scene.add(medium)
    return scene.compile(dev)


@pytest.mark.parametrize("medium", ["iso", "bare"])
def test_cpu_scene_and_bare_medium_take_the_plain_chain(monkeypatch, medium):
    """A CPU scene takes `shoot_level_plain` a level, with a preset or a
    medium of bare callables alike, and never builds or reaches K-shoot."""
    def no_library():
        raise AssertionError("the CPU path reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(ks, "ShootChunk", None)
    levels = []
    real = ks.shoot_level_plain
    monkeypatch.setattr(ks, "shoot_level_plain",
                        lambda *a, **k: levels.append(a[4]) or real(*a, **k))
    scene = _lampshade_scene("cpu", _bare_medium() if medium == "bare" else "iso")
    li, _ = tph._find_object_light(scene)
    before = ks.shoot_level.launches
    s_rows, v_rows, dropped = tph._shoot_launch(scene, scene.tables, li, 1.0, 48, 300,
                                                sampling.key(5))
    assert levels == list(range(len(levels))) and len(levels) >= 2
    assert ks.shoot_level.launches == before
    assert s_rows.shape[1] == v_rows.shape[1] == tph.PHOTON_ROW and v_rows.shape[0] > 0
    assert dropped == 0


@pytest.mark.parametrize("medium", [None, "iso", "bare"])
def test_card_scenes_take_the_kernel_whatever_their_medium(monkeypatch, medium):
    """The route is the device's alone: a scene on the card hands its chunk
    to `ShootChunk` with no medium, a preset's or one of bare callables,
    and never to `shoot_level_plain`. Here the lanes stay on the CPU under
    a scene that says CUDA, so `ShootChunk` refuses them: for their device,
    or first for a medium with no preset."""
    def no_plain(*a, **k):
        raise AssertionError("a scene on the card took shoot_level_plain")

    scene = _lampshade_scene("cpu", _bare_medium() if medium == "bare" else medium)
    li, _ = tph._find_object_light(scene)
    emitted = tph._emit(scene, scene.tables, li, 1.0, 64, sampling.key(6))
    monkeypatch.setattr(tph, "_emit", lambda *a: emitted)
    monkeypatch.setattr(ks, "shoot_level_plain", no_plain)
    card = dataclasses.replace(scene, device=torch.device("cuda"))
    want = "no preset" if medium == "bare" else "unsupported device"
    with pytest.raises(ValueError, match=want):
        tph._shoot_launch(card, card.tables, li, 1.0, 48, 64, sampling.key(6))


def test_plain_levels_make_the_chunk():
    """`_shoot_launch` on the CPU is `shoot_level_plain` over the levels:
    the rows of its levels, concatenated and cut at the capacities."""
    scene = _lampshade_scene("cpu")
    li, _ = tph._find_object_light(scene)
    key, n = sampling.key(11), 257
    s_rows, v_rows, dropped = tph._shoot_launch(scene, scene.tables, li, 2.0, 48, n, key)
    ray, power, keys = tph._emit(scene, scene.tables, li, 2.0, n, key)
    s_all, v_all = [], []
    for b in range(48):
        if ray.origin.x.shape[0] == 0:
            break
        hit = intersect.closest_hit(scene, scene.tables, ray)
        s, v, ray, power, keys = ks.shoot_level_plain(ray, power, keys, hit, b, scene.media[0],
                                                      scene.tables["materials"])
        s_all.append(s)
        v_all.append(v)
    assert torch.equal(s_rows, torch.cat(s_all)[:4 * n])
    assert torch.equal(v_rows, torch.cat(v_all)[:10 * n]) and dropped == 0


def _unbuilt_chunk(lanes=4, level=0, max_depth=48):
    """A `ShootChunk` with no card behind it: enough state for
    `shoot_level` to check its arguments, which it does before any launch."""
    chunk = ks.ShootChunk.__new__(ks.ShootChunk)
    chunk.lanes, chunk.level, chunk.max_depth = lanes, level, max_depth
    chunk.offsets = torch.zeros((max_depth + 1, 4), dtype=torch.int32)
    return chunk


def test_wrappers_refuse_what_they_do_not_take(monkeypatch):
    """`ShootChunk` refuses a medium of bare callables, bad keys, lanes,
    material tables and sizes, and lanes off the card; `shoot_level`
    refuses a level out of turn and a hit of the wrong lanes or types,
    before any launch."""
    def no_library():
        raise AssertionError("a refused call reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    scene = _lampshade_scene("cpu")
    mats = scene.tables["materials"]
    li, _ = tph._find_object_light(scene)
    ray, power, keys = tph._emit(scene, scene.tables, li, 1.0, 8, sampling.key(1))
    iso = scene.media[0]
    with pytest.raises(ValueError, match="unsupported device"):
        ks.ShootChunk(ray, power, keys.base, mats, iso, 48, 32, 80)
    with pytest.raises(ValueError, match="unsupported device"):
        ks.ShootChunk(ray, power, keys.base, mats, None, 48, 32, 16)
    with pytest.raises(ValueError, match="float32 tensors on meta"):
        ks.ShootChunk(ray, power, keys.base.to("meta"), mats, None, 48, 32, 16)
    with pytest.raises(ValueError, match="no preset"):
        ks.ShootChunk(ray, power, keys.base, mats, _bare_medium(), 48, 32, 80)
    with pytest.raises(ValueError, match="int64"):
        ks.ShootChunk(ray, power, keys.base.to(torch.int32), mats, iso, 48, 32, 80)
    with pytest.raises(ValueError, match="float32"):
        ks.ShootChunk(Ray(ray.origin, ray.dir.map(lambda c: c.double())), power, keys.base,
                      mats, iso, 48, 32, 80)
    bad_table = type(mats)(mats.kind.long(), mats.albedo, mats.emittance, mats.shininess,
                           mats.ior)
    with pytest.raises(ValueError, match="material table"):
        ks.ShootChunk(ray, power, keys.base, bad_table, iso, 48, 32, 80)
    with pytest.raises(ValueError, match="int32"):
        ks.ShootChunk(ray, power, keys.base, mats, iso, 48, 1 << 31, 80)
    with pytest.raises(ValueError, match="int32"):
        ks.ShootChunk(ray, power, keys.base, mats, iso, -1, 32, 80)
    hit = Hit.none((4,))
    with pytest.raises(ValueError, match="next"):
        ks.shoot_level(_unbuilt_chunk(level=2), hit, 1)
    with pytest.raises(ValueError, match="next"):
        ks.shoot_level(_unbuilt_chunk(level=3, max_depth=3), hit, 3)
    with pytest.raises(ValueError, match="4 lanes"):
        ks.shoot_level(_unbuilt_chunk(), Hit.none((5,)), 0)
    with pytest.raises(ValueError, match="4 lanes"):
        ks.shoot_level(_unbuilt_chunk(), Hit(hit.time, hit.normal, hit.material.long()), 0)
    with pytest.raises(ValueError, match="4 lanes"):
        ks.shoot_level(_unbuilt_chunk(), Hit(hit.time.double(), hit.normal, hit.material), 0)


def test_params_match_the_kernel():
    """`_ShootParams` has the layout that `csrc/photon_shoot.cu` pins with
    its static_asserts, the entry point takes it by reference, its block
    size is the wrapper's, and the wrapper's counter is a span counter."""
    with open(os.path.join(_build.CSRC_DIR, "photon_shoot.cu")) as f:
        src = f.read()
    pinned = dict(re.findall(r"offsetof\(ShootParams, (\w+)\) == (\d+)", src))
    assert len(pinned) >= 10
    assert {k: int(v) for k, v in pinned.items()} == {
        name: getattr(ks._ShootParams, name).offset for name in pinned}
    assert int(re.search(r"sizeof\(ShootParams\) == (\d+)", src).group(1)) == \
        ctypes.sizeof(ks._ShootParams)
    assert re.search(rf"constexpr int kThreads = {ks.THREADS};", src)
    assert re.search(r"constexpr int kRow = 12;", src) and ks.ROW == tph.PHOTON_ROW
    assert re.search(r'extern "C" int rpt_photon_shoot_level\(const ShootParams\* params, '
                     r'void\* stream\)', src)
    assert _build._SIGNATURES["rpt_photon_shoot_level"] == [ctypes.c_void_p, ctypes.c_void_p]
    assert ("rpt_tpu_torch.ops.photon_shoot", "shoot_level") in tracing.COUNTERS
    assert '#include "threefry.cuh"' in src


# ---------------------------------------------------------------------------
# On the card: the kernel against the chain, bit for bit


def _diff(name, a, b) -> str:
    """Where ``a`` and ``b`` differ: the rows (lanes) and columns, and the
    first differing row of each."""
    if a.shape != b.shape:
        return f"{name}: shapes {tuple(a.shape)} and {tuple(b.shape)}"
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    bad = ((a2 != b2) & ~(a2.isnan() & b2.isnan()) if a2.is_floating_point() else a2 != b2)
    rows = bad.any(dim=1).nonzero().flatten()
    first = int(rows[0]) if rows.numel() else -1
    return (f"{name}: {rows.numel()} of {a.shape[0]} rows differ, by column "
            f"{bad.sum(dim=0).tolist()}; first row {first}: {a2[first].tolist()} against "
            f"{b2[first].tolist()}")


def _expect_equal(name, a, b):
    assert torch.equal(a, b), _diff(name, a, b)


def _compare_chunk(scene, n, key, s_cap=None, v_cap=None, max_depth=48, power=None):
    """One chunk of ``n`` photons from ``key`` through K-shoot and through
    `shoot_level_plain`, compared after every level (the survivors' rays,
    powers and keys, the level's deposit rows below the capacities, the
    survivor count) and at the end (`ShootChunk.rows` against the chain's
    rows cut at the capacities, the dropped count). Returns the levels,
    the rows and the dropped count."""
    medium = scene.media[0] if scene.media else None
    s_cap = 4 * n if s_cap is None else s_cap
    v_cap = (10 * n if medium is not None else 16) if v_cap is None else v_cap
    mats = scene.tables["materials"]
    li, _ = tph._find_object_light(scene)
    ray, power, keys = tph._emit(scene, scene.tables, li, 3.0 / n if power is None else power,
                                 n, key)
    chunk = ks.ShootChunk(ray, power, keys.base, mats, medium, max_depth, s_cap, v_cap)
    s_all, v_all = [], []
    s_off = v_off = 0
    for b in range(max_depth):
        if chunk.lanes == 0:
            break
        hit = intersect.closest_hit(scene, scene.tables, ray)
        s, v, ray, power, keys = ks.shoot_level_plain(ray, power, keys, hit, b, medium, mats)
        ks.shoot_level(chunk, hit, b)
        s_all.append(s)
        v_all.append(v)
        where = f"level {b}"
        assert chunk.lanes == ray.origin.x.shape[0], (
            f"{where}: {chunk.lanes} survivors, the chain {ray.origin.x.shape[0]}")
        got, want = chunk.ray(), ray
        for label, g, w in (("origin", got.origin, want.origin), ("dir", got.dir, want.dir),
                            ("power", chunk.power(), power)):
            _expect_equal(f"{where} {label}", torch.stack([g.x, g.y, g.z], dim=1),
                          torch.stack([w.x, w.y, w.z], dim=1).expand(chunk.lanes, 3))
        _expect_equal(f"{where} keys", chunk.keys(), keys.base)
        s_end, v_end = chunk.offsets[b + 1, :2].tolist()
        assert (s_end - s_off, v_end - v_off) == (s.shape[0], v.shape[0]), where
        _expect_equal(f"{where} surface rows", chunk.surface[s_off:min(s_end, s_cap)],
                      s[:max(0, s_cap - s_off)])
        _expect_equal(f"{where} volume rows", chunk.volume[v_off:min(v_end, v_cap)],
                      v[:max(0, v_cap - v_off)])
        s_off, v_off = s_end, v_end
    assert chunk.lanes == 0 or chunk.level == max_depth
    s_rows, v_rows, dropped = chunk.rows()
    s_ref, v_ref = torch.cat(s_all), torch.cat(v_all)
    _expect_equal("surface rows", s_rows, s_ref[:s_cap])
    _expect_equal("volume rows", v_rows, v_ref[:v_cap])
    assert dropped == max(0, s_ref.shape[0] - s_cap) + max(0, v_ref.shape[0] - v_cap)
    return chunk.level, s_rows, v_rows, dropped


def _chunks(scene, photons, key, chunk=CHUNK, first=None):
    """`shoot_photons_device`'s chunks of ``photons``: the equal chunk size
    and each chunk's key, the first ``first`` of them."""
    nchunks = max(1, -(-photons // chunk))
    n_eq = -(-photons // nchunks)
    return [(n_eq, sampling.fold_in(key, ci * n_eq)) for ci in range(nchunks)][:first]


@pytest.mark.cuda
def test_kernel_equals_the_chain_on_the_lampshade():
    """The beam cell's shoot: 1M photons, two chunks of 500,000, the
    lampshade in its thin isotropic fog (K-prim cubes, K-dense triangles)."""
    dev = _card()
    scene = _lampshade_scene(dev)
    key = sampling.fold_in(sampling.key(3400000043, dev), 1)
    for n, k in _chunks(scene, 1_000_000, key):
        levels, s_rows, v_rows, _ = _compare_chunk(scene, n, k)
        assert levels > 10 and s_rows.shape[0] > 0 and v_rows.shape[0] > 0


@pytest.mark.cuda
def test_kernel_equals_the_chain_on_the_skybox():
    """The skybox cell's shoot: two of its 20 chunks of 500,000 photons in
    the fog under the open ceiling."""
    dev = _card()
    r = tsky.renderer(dev)
    scene = r.compiled
    key = sampling.fold_in(sampling.key(3500000003, dev), 1)
    for n, k in _chunks(scene, 10_000_000, key, first=2):
        levels, s_rows, v_rows, _ = _compare_chunk(scene, n, k)
        assert levels > 10 and s_rows.shape[0] > 0 and v_rows.shape[0] > 0


@pytest.mark.cuda
def test_kernel_equals_the_chain_with_no_medium():
    """`examples/torch_photon_map.py`'s scene, no medium: surfaces only,
    the volume buffer of 16 rows left empty."""
    dev = _card()
    scene = tpm.renderer(dev).compiled
    assert not scene.media
    levels, s_rows, v_rows, dropped = _compare_chunk(scene, 300_000,
                                                     sampling.key(2024, dev))
    assert levels > 3 and s_rows.shape[0] > 0 and v_rows.shape[0] == 0 and dropped == 0


@pytest.mark.cuda
@pytest.mark.parametrize("g", [0.6, -0.45, 1e-7])
def test_kernel_equals_the_chain_in_henyey_greenstein(g):
    """The lampshade in a Henyey-Greenstein medium dense enough to scatter
    often: forward and backward lobes (the inverted CDF) and a g under
    1e-6 (the uniform sphere with the lobe's phase)."""
    dev = _card()
    scene = _lampshade_scene(dev, Medium.henyey_greenstein(2e-4, 3e-3, g))
    levels, _, v_rows, _ = _compare_chunk(scene, 200_000, sampling.key(77, dev))
    assert levels > 10 and v_rows.shape[0] > 100_000


@pytest.mark.cuda
def test_kernel_equals_the_chain_in_the_glowing_fog():
    """`colored_glowing_fog`: the colour splits at y = 250 inside the box."""
    dev = _card()
    scene = _lampshade_scene(dev, Medium.colored_glowing_fog(2e-4, 3e-3))
    levels, _, v_rows, _ = _compare_chunk(scene, 200_000, sampling.key(78, dev))
    ys = v_rows[:, 1]
    assert levels > 10 and bool((ys > GLOW_SPLIT_Y).any()) and bool((ys <= GLOW_SPLIT_Y).any())


def _lobes():
    """A mirror sphere, a glass sphere (ior 1.5: total internal reflection
    inside), a Phong sphere and a Phong cube, in the lampshade's box."""
    def sphere(r, at):
        return rpt.sphere().scale((r, r, r)).translate(at)

    return [
        rpt.Object(sphere(80.0, (150.0, 80.0, 150.0))).material(rpt.Material.mirror()),
        rpt.Object(sphere(90.0, (400.0, 90.0, 200.0))).material(rpt.Material.transmissive(1.5)),
        rpt.Object(sphere(70.0, (280.0, 300.0, 350.0))).material(
            rpt.Material.specular(rpt.hex_color(0x99CCEE), 20.0)),
        rpt.Object(rpt.cube().scale((60.0, 60.0, 60.0)).translate((120.0, 30.0, 420.0))).material(
            rpt.Material.metallic(rpt.hex_color(0xEEBB66), 3.5)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("medium", [None, "iso"])
def test_kernel_equals_the_chain_on_mirror_glass_and_phong(medium):
    """Every material kind: mirror (no deposit), transmissive (reflection,
    refraction, total internal reflection), Phong lobes, Lambertian."""
    dev = _card()
    scene = _lampshade_scene(dev, medium, _lobes())
    kinds = set(scene.tables["materials"].kind.tolist())
    assert kinds == {0, 1, 2, 3}
    levels, s_rows, _, _ = _compare_chunk(scene, 300_000, sampling.key(79, dev))
    assert levels > 10 and s_rows.shape[0] > 0


@pytest.mark.cuda
def test_kernel_equals_the_chain_at_a_ragged_chunk():
    """A chunk of 100,003 photons (no power of two, a ragged last block)
    and one of a single photon."""
    dev = _card()
    scene = _lampshade_scene(dev)
    _compare_chunk(scene, 100_003, sampling.key(80, dev))
    _compare_chunk(scene, 1, sampling.key(81, dev))


@pytest.mark.cuda
def test_kernel_drops_and_counts_past_the_capacities():
    """Capacities far under the deposits: the rows past them dropped and
    counted as the chain's ``rows[:cap]`` does, the rows below them equal;
    and a depth limit that ends the chunk with lanes alive."""
    dev = _card()
    scene = _lampshade_scene(dev)
    _, s_rows, v_rows, dropped = _compare_chunk(scene, 50_000, sampling.key(82, dev),
                                                s_cap=7_001, v_cap=20_011)
    assert s_rows.shape[0] == 7_001 and v_rows.shape[0] == 20_011 and dropped > 0
    levels, *_ = _compare_chunk(scene, 50_000, sampling.key(83, dev), max_depth=5)
    assert levels == 5


@pytest.mark.cuda
def test_shoot_launch_takes_the_kernel_on_the_card():
    """`_shoot_launch` on a CUDA scene: one K-shoot call a level, each
    inside its `photon.shoot_level` span, and the chunk's rows those of the
    plain chain; a medium of bare callables is refused."""
    dev = _card()
    scene = _lampshade_scene(dev)
    li, _ = tph._find_object_light(scene)
    key = sampling.key(84, dev)
    tracing.clear()
    before = ks.shoot_level.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        s_rows, v_rows, dropped = tph._shoot_launch(scene, scene.tables, li, 1e-5, 48, 100_000,
                                                    key)
    levels = [s for s in tracing.spans() if s.name == "photon.shoot_level"]
    assert levels and all(s.launches.get("shoot_level") == 1 for s in levels)
    assert ks.shoot_level.launches - before == len(levels)
    _, s_ref, v_ref, d_ref = _compare_chunk(scene, 100_000, key, power=1e-5)
    _expect_equal("surface rows", s_rows, s_ref)
    _expect_equal("volume rows", v_rows, v_ref)
    assert dropped == d_ref
    bare = _lampshade_scene(dev, _bare_medium())
    before = ks.shoot_level.launches
    with pytest.raises(ValueError, match="no preset"):
        tph._shoot_launch(bare, bare.tables, li, 1e-5, 48, 1_000, key)
    assert ks.shoot_level.launches == before
