"""`rpt_tpu_torch.parallel` on the CPU: ranks spawned as processes over
gloo (a `FileStore` in a temporary directory: no port, no network), one
thread each, against `rpt_tpu.parallel` on the JAX package's virtual CPU
mesh and against the port's own single-rank results.

The ranks run every case of a world size in one spawn (worlds of 1, 2
and 4 ranks, all started at once), so the file pays for seven process
starts. Every process group has a 60 s timeout and the spawn a deadline,
so a rank that hangs fails its test instead of running into the suite's
limit. The ranks import neither jax nor `rpt_tpu` (this module imports
them inside the tests only).

Tolerances, and why:
- `render_sharded` against `rpt_tpu.parallel.render_sharded`: the same
  keys, so the limits `tests/test_torch_path.py` holds `trace_surface` to:
  per-pixel mean |diff| <= 0.5% of the mean radiance, means within 0.5%;
  with a medium those of `tests/test_torch_volumetric.py`'s renders, 1%
  and 1% (paths in a medium diverge on last-bit differences);
- the port against itself across partitions: the same per-lane values
  summed in another order over sp, rtol 1e-5 (atol 1e-7); a dp-only
  split and two equal calls are bit-identical;
- `shoot_photons_sharded`: bit-equal to the port's own per-rank
  `_shoot_launch` at ``fold_in(key, rank)``; deposit counts and energy
  within 8% of the JAX package's sharded shoot at 20,000 photons (over
  eight devices, so other keys), as `tests/test_parallel.py` holds JAX
  against itself;
- `photon_render_sharded` given the JAX package's photon rows: the
  photon-map limits of `tests/test_torch_photon_kinds.py`, per-pixel mean
  |diff| <= 0.5% of the mean radiance and the means within 0.5%.
"""

import datetime
import math
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import rpt_tpu_torch as tr
from rpt_tpu_torch import parallel, sampling
from rpt_tpu_torch.integrators import photon as tph

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402

DEADLINE_S = 240  # every rank of every world must have finished by then
SIZE = (40, 24, 4, 2, 7)  # width, height, spp, bounces, key: tests/test_parallel.py:31-37
MEDIUM = (16, 16, 2, 8)  # width, height, spp, media depth: the lampshade's fog
PHOTON = (24, 16, 2, 8, 5)  # width, height, spp, gather size, key: tests/test_parallel.py:108
SHOOT = (20_000, 100.0, 5)  # photons, watts, key: tests/test_parallel.py:53-78


def _sphere_scene(lib):
    """`tests/test_parallel.py:12-26` in either package (``lib``)."""
    scene = lib.Scene()
    scene.add(lib.Object(lib.sphere()))
    scene.add(lib.Object(lib.plane((0, 1, 0), -1.0)).material(
        lib.Material.diffuse(lib.hex_color(0xAAAAAA))))
    scene.add(lib.Light.Object(
        lib.Object(lib.sphere().scale((2, 2, 2)).translate((0, 12, 0))).material(
            lib.Material.light(lib.hex_color(0xFFFFFF), 40.0))))
    return scene


def _sphere_camera(lib):
    return lib.Camera.look_at((-2.5, 4, 6.5), (0, -0.25, 0), (0, 1, 0), math.pi / 4)


def _floor_scene(lib):
    """The photon scene of `tests/test_parallel.py:108-150`: a floor and a
    wall under a small square light."""
    scene = lib.Scene()
    white = lib.Material.diffuse(lib.hex_color(0xAAAAAA))
    scene.add(lib.Object(lib.polygon([(0, 0, 0), (0, 0, 10), (10, 0, 10), (10, 0, 0)]))
              .material(white))
    scene.add(lib.Object(lib.polygon([(0, 0, 0), (10, 0, 0), (10, 10, 0), (0, 10, 0)]))
              .material(white))
    scene.add((lib.polygon([(6, 9.9, 4), (6, 9.9, 6), (4, 9.9, 6), (4, 9.9, 4)]),
               lib.Material.light(lib.hex_color(0xFFFFFF), 50.0)))
    return scene


def _photon_camera(lib):
    return lib.Camera.look_at((5, 5, 14), (5, 5, 0), (0, 1, 0), math.pi / 3)


def _medium_renderer():
    return tlamp.renderer("cpu", size=MEDIUM[0], bounce=6, sample=MEDIUM[2], photons=4000,
                          seed=42)


# ---------------------------------------------------------------------------
# What a rank runs


def _render(dp_sp, width=SIZE[0], height=SIZE[1], spp=SIZE[2]):
    mesh = parallel.make_mesh(dp_sp[0] * dp_sp[1], sp=dp_sp[1], device_type="cpu")
    scene = _sphere_scene(tr).compile("cpu")
    return parallel.render_sharded(scene, _sphere_camera(tr), width, height, spp, SIZE[3], mesh,
                                   sampling.key(SIZE[4]))


def _render_medium(dp_sp):
    mesh = parallel.make_mesh(dp_sp[0] * dp_sp[1], sp=dp_sp[1], device_type="cpu")
    r = _medium_renderer()
    return parallel.render_sharded(r.compiled, r.camera, MEDIUM[0], MEDIUM[1], MEDIUM[2],
                                   r.max_bounces_, mesh, sampling.key(42),
                                   media_max_depth=MEDIUM[3])


def _shoot(dp_sp):
    mesh = parallel.make_mesh(dp_sp[0] * dp_sp[1], sp=dp_sp[1], device_type="cpu")
    scene = _floor_scene(tr).compile("cpu")
    return parallel.shoot_photons_sharded(scene, sampling.key(SHOOT[2]), SHOOT[0], SHOOT[1],
                                          tph.PHOTON_MAP, mesh)


def _photon_pass(dp_sp, rows):
    """The camera pass over a map built from the JAX package's photon
    rows, saved in ``rows``."""
    with np.load(rows) as f:
        surface, volume = f["surface"], f["volume"]
    mesh = parallel.make_mesh(dp_sp[0] * dp_sp[1], sp=dp_sp[1], device_type="cpu")
    scene = _floor_scene(tr).compile("cpu")
    g = PHOTON[3]
    pmap = tph.build_photon_map(scene, scene.tables, torch.from_numpy(surface),
                                torch.from_numpy(volume), tph.PHOTON_MAP, g, g,
                                np.random.default_rng(17))
    return parallel.photon_render_sharded(scene, _photon_camera(tr), PHOTON[0], PHOTON[1],
                                          PHOTON[2], pmap, tph.PHOTON_MAP, g, g, mesh,
                                          sampling.key(PHOTON[4]))


def _mesh_of(n_devices, sp):
    parallel.make_mesh(n_devices, sp=sp, device_type="cpu")


def _rank_main(rank, world, store, cases, out):
    """One rank: joins the gloo group, runs every case in order (a case
    that raises records its exception; every case checks its arguments
    before its first collective, so no rank is left waiting) and saves
    what each returned."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        results = {}
        for name, fn, kwargs in cases:
            try:
                results[name] = ("ok", globals()[fn](**kwargs))
            except Exception as e:  # noqa: BLE001 - the parent asserts what was raised
                results[name] = ("raised", f"{type(e).__name__}: {e}")
        torch.save(results, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _start(world, cases, tmp):
    ctx = multiprocessing.get_context("spawn")
    store, out = os.path.join(tmp, f"store{world}"), os.path.join(tmp, f"out{world}")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, cases, out))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def _arrays(value):
    return value if isinstance(value, tuple) else (value,)


def _join(procs, out, deadline):
    """Every rank's results, after checking that each rank ended in time,
    cleanly, and returned the same arrays as rank 0."""
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} rank(s) still running at the deadline"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    results = [torch.load(f"{out}.{r}", weights_only=False) for r in range(len(procs))]
    for other in results[1:]:
        assert other.keys() == results[0].keys()
        for name, (status, value) in results[0].items():
            assert other[name][0] == status, name
            if status == "ok" and value is not None:
                for a, b in zip(_arrays(value), _arrays(other[name][1])):
                    assert np.array_equal(a, b), name
    return results[0]


CASES = {
    1: [("render", "_render", {"dp_sp": (1, 1)}),
        ("render_7x5", "_render", {"dp_sp": (1, 1), "width": 7, "height": 5}),
        ("medium", "_render_medium", {"dp_sp": (1, 1)}),
        ("shoot", "_shoot", {"dp_sp": (1, 1)})],
    2: [("render", "_render", {"dp_sp": (2, 1)}),
        ("render_7x5", "_render", {"dp_sp": (2, 1), "width": 7, "height": 5}),
        ("medium", "_render_medium", {"dp_sp": (1, 2)}),
        ("mesh_of_1", "_mesh_of", {"n_devices": 1, "sp": 1}),
        ("sp_3", "_mesh_of", {"n_devices": 2, "sp": 3}),
        ("shoot", "_shoot", {"dp_sp": (2, 1)})],
    4: [("render", "_render", {"dp_sp": (2, 2)}),
        ("render_again", "_render", {"dp_sp": (2, 2)}),
        ("odd_samples", "_render", {"dp_sp": (2, 2), "spp": 3}),
        ("medium", "_render_medium", {"dp_sp": (2, 2)}),
        ("shoot", "_shoot", {"dp_sp": (2, 2)})],
}


def _jax_references(rows):
    """`rpt_tpu.parallel` on the JAX package's virtual CPU mesh: its
    sharded shoot of the photon scene (20,000 photons over a (4, 2) mesh,
    key 5), saved in ``rows`` for the ranks' camera pass; the camera pass
    over its map; the sphere and fog renders on a (1, 1) mesh. (Computed
    before the ranks start: beside them, on a shared machine's cores, both
    took longer than one after the other.)"""
    import jax

    import rpt_tpu as jr
    from rpt_tpu import parallel as jpar
    from rpt_tpu.integrators import photon as jph
    from test_torch_volumetric import _jax_renderer

    one = jpar.make_mesh(1, sp=1)
    cs = _floor_scene(jr).compile()
    photons, watts, key = SHOOT
    surface, volume = jpar.shoot_photons_sharded(cs, jax.random.key(key), photons, watts,
                                                 jph.PHOTON_MAP, jpar.make_mesh(8, sp=2))
    np.savez(rows, surface=np.ascontiguousarray(surface, np.float32),
             volume=np.ascontiguousarray(volume, np.float32))
    w, h, spp, g, key = PHOTON
    pmap = jph.build_photon_map(cs, cs.tables, surface, volume, jph.PHOTON_MAP, g, g,
                                np.random.default_rng(17))
    ref = {"shoot": surface,
           "photon": jpar.photon_render_sharded(cs, _photon_camera(jr), w, h, spp, pmap,
                                                jph.PHOTON_MAP, g, g, one, jax.random.key(key))}
    w, h, spp, bounces, key = SIZE
    ref["render"] = jpar.render_sharded(_sphere_scene(jr).compile(), _sphere_camera(jr), w, h,
                                        spp, bounces, one, jax.random.key(key))
    w, h, spp, depth = MEDIUM
    j = _jax_renderer(w, spp, depth)
    ref["medium"] = jpar.render_sharded(j.compiled, j.camera, w, h, spp, j.max_bounces_, one,
                                        jax.random.key(42), media_max_depth=depth)
    return ref


@pytest.fixture(scope="module")
def run():
    """The JAX references, then every case of every world, the three
    worlds spawned at once: (rank 0's results by world size, the
    references)."""
    with tempfile.TemporaryDirectory() as tmp:
        rows = os.path.join(tmp, "rows.npz")
        ref = _jax_references(rows)
        cases = {w: c + [("photon", "_photon_pass", {"dp_sp": dp_sp, "rows": rows})]
                 for (w, c), dp_sp in zip(CASES.items(), ((1, 1), (2, 1), (2, 2)))}
        started = {w: _start(w, c, tmp) for w, c in cases.items()}
        deadline = time.monotonic() + DEADLINE_S
        return {w: _join(*started[w], deadline) for w in started}, ref


def _ok(ranks, world, name):
    status, value = ranks[world][name]
    assert status == "ok", value
    return value


def _close_images(got, ref, pixel_limit, mean_limit):
    assert np.isfinite(got).all() and got.mean() > 0
    assert np.abs(got - ref).mean() / ref.mean() <= pixel_limit
    assert abs(got.mean() / ref.mean() - 1.0) <= mean_limit


def test_render_sharded_matches_jax(run):
    """The sphere scene at 40x24, 4 spp, 2 bounces, key 7 on (1, 1), (2, 1)
    and (2, 2) against `rpt_tpu.parallel.render_sharded` on a (1, 1) mesh
    (module docstring for the limits)."""
    ranks, ref = run
    single = _ok(ranks, 1, "render")
    assert single.shape == (SIZE[0] * SIZE[1], 3) and single.dtype == np.float32
    for world in (1, 2, 4):
        _close_images(_ok(ranks, world, "render"), ref["render"], 0.005, 0.005)


def test_render_sharded_agrees_across_partitions(run):
    """The port against itself: a dp-only split bit-equal to one rank, the
    (2, 2) split within rtol 1e-5 (sums over sp in another order), and two
    equal calls bit-identical."""
    ranks, _ = run
    single = _ok(ranks, 1, "render")
    assert np.array_equal(_ok(ranks, 2, "render"), single)
    np.testing.assert_allclose(_ok(ranks, 4, "render"), single, rtol=1e-5, atol=1e-7)
    assert np.array_equal(_ok(ranks, 4, "render_again"), _ok(ranks, 4, "render"))


def test_render_sharded_equals_the_single_process_pass(run):
    """One rank's sum is `_path_pass`'s for the same key, bit for bit: the
    same lanes in the same Morton order, the same per-pixel keys."""
    from rpt_tpu_torch import renderer

    ranks, _ = run
    w, h, spp, bounces, key = SIZE
    scene = _sphere_scene(tr).compile("cpu")
    total, _ = renderer._path_pass(scene, _sphere_camera(tr), w, h, sampling.key(key), 0, spp,
                                   bounces)
    assert np.array_equal(_ok(ranks, 1, "render"), total.astype(np.float32))


def test_render_sharded_with_a_medium(run):
    """The lampshade in fog (16x16, 2 spp, 8 levels of `trace_volumetric`)
    on (1, 1), (1, 2) and (2, 2) against the JAX package's sharded render."""
    ranks, ref = run
    single = _ok(ranks, 1, "medium")
    for world in (1, 2, 4):
        _close_images(_ok(ranks, world, "medium"), ref["medium"], 0.01, 0.01)
    for world in (2, 4):
        np.testing.assert_allclose(_ok(ranks, world, "medium"), single, rtol=1e-5, atol=1e-7)


def test_padding_and_errors(run):
    """7x5 pixels over dp = 2 pad to 36 and strip back to 35, the same sums
    as one rank's; 3 samples over sp = 2 raise, and so do a mesh of another
    size than the world and an sp that does not divide it."""
    ranks, _ = run
    padded = _ok(ranks, 2, "render_7x5")
    assert padded.shape == (35, 3)
    assert np.array_equal(padded, _ok(ranks, 1, "render_7x5"))
    status, message = ranks[4]["odd_samples"]
    assert status == "raised" and "num_samples=3" in message
    status, message = ranks[2]["mesh_of_1"]
    assert status == "raised" and "world of 2" in message
    status, message = ranks[2]["sp_3"]
    assert status == "raised" and "sp=3" in message


def test_make_mesh_needs_a_process_group_and_the_card():
    """No process group, no mesh; and the card is the default device,
    never replaced by the CPU."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(1, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            parallel.make_mesh(1)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shoot_rows_equal_the_per_rank_launches(run, world):
    """Each rank's rows are `_shoot_launch`'s at ``fold_in(key, rank)``,
    ``ceil(count / n)`` photons at the power of all ``n * per_dev``
    emitted, clipped at the capacities, gathered in rank order."""
    ranks, _ = run
    photons, watts, key = SHOOT
    scene = _floor_scene(tr).compile("cpu")
    per_dev = -(-photons // world)
    li, _ = tph._find_object_light(scene)
    parts = [tph._shoot_launch(scene, scene.tables, li, watts / (world * per_dev), 48, per_dev,
                               sampling.fold_in(sampling.key(key), r)) for r in range(world)]
    surface, volume = _ok(ranks, world, "shoot")
    assert surface.dtype == np.float32 and volume.shape == (0, tph.PHOTON_ROW)
    assert np.array_equal(surface, torch.cat([p[0] for p in parts]).numpy())


def test_shoot_matches_jax(run):
    """20,000 photons over four ranks against the JAX package's sharded
    shoot over eight devices (other keys a device, so the same statistics,
    not the same rows): deposit counts and energy within 8%."""
    ranks, refs = run
    ref = refs["shoot"]
    got, _ = _ok(ranks, 4, "shoot")
    assert abs(len(got) - len(ref)) / len(ref) < 0.08
    e_ref = np.linalg.norm(ref[:, 6:9], axis=1).sum()
    e_got = np.linalg.norm(got[:, 6:9], axis=1).sum()
    assert abs(e_got - e_ref) / e_ref < 0.08


def test_photon_render_sharded_matches_jax(run):
    """The JAX package's 20,000 sharded photons built into each package's
    map; the camera pass (24x16, 2 spp, gather 8 / 8, key 5) on (1, 1),
    (2, 1) and (2, 2) against `rpt_tpu.parallel.photon_render_sharded` on
    a (1, 1) mesh, and the port's partitions against each other."""
    ranks, ref = run
    single = _ok(ranks, 1, "photon")
    for world in (1, 2, 4):
        _close_images(_ok(ranks, world, "photon"), ref["photon"], 0.005, 0.005)
    assert np.array_equal(_ok(ranks, 2, "photon"), single)
    np.testing.assert_allclose(_ok(ranks, 4, "photon"), single, rtol=1e-5, atol=1e-7)
