"""The path-tracing slice of the port against `rpt_tpu` on the CPU: the
plain BVH traversal (the spec of kernels K1 and K2), `trace_surface` on
the bench scene with a small mesh, and `Renderer.render` on the sphere
and Cornell goldens.

Sizes keep the JAX package on its exact engine: meshes under
`CLUSTERS_MIN_TRIS` (16384 triangles) and wavefronts under
`TILED_MIN_RAYS` (4096 lanes) run `rpt_tpu.intersect._traverse`.

Tolerances, and why:
- traversal: the JAX package compiles with XLA, which contracts some
  multiply-adds into FMAs that torch rounds twice, so a grazing hit may
  flip a lane: `tri` (or the any-hit flag) equal on >= 99.9% of lanes;
  where `tri` agrees, t within rtol 1e-5 or atol 1e-6 (t = pn.(v1-o) /
  pn.d carries an absolute error of a few eps x the mesh scale of ~2,
  which dominates for rays leaving the mesh), and u, v, w within rtol
  1e-5 or atol 1e-4 (they divide differences of products by the
  denominator d00*d11 - d01^2, which is small on the blob's sliver pole
  triangles);
- `trace_surface`: the same rays and keys, so per-pixel radiance agrees up
  to those flips: per-pixel mean |diff| / image mean <= 0.5%, image means
  within 0.5%;
- goldens: `tests/test_golden.py::_check`'s limits, mean |diff| / mean <
  0.015 and p99 |diff| / mean < 0.12, with no floor.
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
from rpt_tpu import intersect as jint
from rpt_tpu.meshes import displaced_blob as jax_displaced_blob
from rpt_tpu.ray import Ray as JRay
from rpt_tpu.renderer import build_launch
from rpt_tpu.vec import Vec3 as JVec3
import rpt_tpu_torch as tr
from rpt_tpu_torch import intersect as tint
from rpt_tpu_torch import renderer as trenderer
from rpt_tpu_torch.accel.bvh import build_bvh, pack_bvh
from rpt_tpu_torch.meshes import displaced_blob
from rpt_tpu_torch.ray import Ray as TRay
from rpt_tpu_torch.vec import Vec3 as TVec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_cornell  # noqa: E402
import torch_dragon  # noqa: E402
import torch_sphere  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MESH = (48, 49)  # displaced_blob grid: 4704 triangles


@pytest.fixture(scope="module")
def blob_tables():
    """`displaced_blob(48, 49)` packed once, as torch and JAX tables."""
    mesh = displaced_blob(*MESH)
    v, n = mesh.vertices, mesh.normals
    nodes, leaves, shade, depth = pack_bvh(build_bvh(v.min(1), v.max(1)), v, n,
                                           np.zeros(len(v), np.int32))
    tb = tint.BVHTables(torch.from_numpy(nodes), torch.from_numpy(leaves),
                        torch.from_numpy(shade), depth)
    jb = jint.BVHTables(jnp.asarray(nodes), jnp.asarray(leaves), jnp.asarray(shade), depth)
    return mesh, tb, jb


def _traversal_rays(mesh, n=2048, seed=0):
    """A quarter of the rays start on the mesh (points computed in f32
    from barycentrics), half start outside and aim at it, the rest are
    random; limits in [0, 4) with every 7th lane -1, and every 5th lane
    masked off."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-2.5, 2.5, (n, 3))
    q = n // 4
    tri = mesh.vertices[rng.integers(0, len(mesh), q)].astype(np.float32)
    b = rng.dirichlet(np.ones(3), q).astype(np.float32)
    o[:q] = (tri * b[:, :, None]).sum(1)
    aim = rng.uniform(-0.5, 0.5, (n // 2, 3)) - o[q:q + n // 2]
    d[q:q + n // 2] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    limit = rng.uniform(0.0, 4.0, n)
    limit[::7] = -1.0
    active = np.ones(n, bool)
    active[::5] = False
    return (o.astype(np.float32), d.astype(np.float32), limit.astype(np.float32), active)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_traverse_matches_jax(blob_tables, any_hit):
    mesh, tb, jb = blob_tables
    o, d, limit, active = _traversal_rays(mesh)
    n = len(o)
    t_min = 1e-4
    if not any_hit:
        limit = np.full(n, np.inf, np.float32)
    inf = np.full(n, np.inf, np.float32)
    jray = JRay(JVec3.from_array(o), JVec3.from_array(d))
    tray = TRay(TVec3.from_array(o), TVec3.from_array(d))
    jt = [np.asarray(a) for a in jint._traverse(jb, jray, t_min, jnp.asarray(limit),
                                                 jnp.asarray(inf), any_hit,
                                                 active=jnp.asarray(active))]
    tt = [a.numpy() for a in tint._traverse(tb, tray, t_min, torch.tensor(limit),
                                            torch.tensor(inf), any_hit,
                                            active=torch.tensor(active))]
    if any_hit:
        j_occ, t_occ = jt[0] < limit, tt[0] < limit
        assert 0.1 < j_occ.mean() < 0.9
        assert not t_occ[~active].any() and not t_occ[limit <= t_min].any()
        assert (j_occ == t_occ).mean() >= 0.999
        return
    same = jt[1] == tt[1]
    assert same.mean() >= 0.999
    hit = same & (jt[1] >= 0)
    assert 0.3 < hit.mean() < 0.9
    assert (tt[1][~active] == -1).all()
    np.testing.assert_allclose(tt[0][hit], jt[0][hit], rtol=1e-5, atol=1e-6)
    for a, b in zip(tt[2:], jt[2:]):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-4)


def _jax_bench_scene(mesh):
    scene = jr.Scene()
    scene.add(jr.Object(mesh.scale((3.4, 3.4, 3.4)).rotate_y(math.pi / 2)).material(
        jr.Material.specular(jr.hex_color(0xB7CA79), 0.1)))
    scene.add(jr.Object(jr.plane((0.0, 1.0, 0.0), -1.0)).material(
        jr.Material.diffuse(jr.hex_color(0xAAAAAA))))
    scene.add(jr.Light.Ambient((0.01, 0.01, 0.01)))
    scene.add(jr.Light.Object(
        jr.Object(jr.sphere().scale((2.0, 2.0, 2.0)).translate((0.0, 20.0, 3.0))).material(
            jr.Material.light((1.0, 1.0, 1.0), 160.0))))
    scene.add(jr.Light.Object(
        jr.Object(jr.sphere().scale((0.05, 0.05, 0.05)).translate((-1.0, 0.71, 0.0))).material(
            jr.Material.light(jr.hex_color(0xFFAAAA), 400.0))))
    return scene


@pytest.mark.parametrize("nee_mode", ["occlusion", "exact"])
def test_trace_surface_matches_jax(nee_mode):
    """The bench scene (`bench.py:94-122`) with a 4704-triangle mesh,
    32x32, 2 spp, 2 bounces, seed 0: the port's per-sample launch against
    `rpt_tpu.renderer.build_launch` on the same keys, under both shadow
    tests (one batched any-hit query, or the reference's closest hit at
    the light)."""
    size, spp, bounces = 32, 2, 2
    jscene = _jax_bench_scene(jax_displaced_blob(*MESH))
    jscene.nee_mode = nee_mode
    jc = jscene.compile()
    cam = jr.Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    fn = jax.jit(build_launch(jc, cam, size, size, bounces, 32, spp))
    ref = np.asarray(fn(jc.tables, jax.random.key(0), jnp.int32(0))).astype(np.float64)

    tscene = torch_dragon.build_scene(*MESH)
    tscene.nee_mode = nee_mode
    r = torch_dragon.renderer("cpu", size=size, spp=spp, scene=tscene)
    tc = r.compiled
    assert tc.nee_mode == jc.nee_mode == nee_mode
    assert tc.n_tris == jc.n_tris and tc.tables["bvh"].leaves.shape[0] > tint.DENSE_TRI_ROWS
    got, segments = trenderer._path_pass(tc, r.camera, size, size, tr.sampling.key(0), 0, spp,
                                         bounces)
    assert np.isfinite(got).all() and got.mean() > 0
    scale = ref.mean()
    assert np.abs(got - ref).mean() / scale <= 0.005
    assert abs(got.mean() / scale - 1.0) <= 0.005
    # camera segments plus, per level, bounces and two shadow rays per hit
    assert size * size * spp < segments <= size * size * spp * (bounces + 1) * 3


@pytest.mark.parametrize("name", ["sphere_64x36_16spp", "cornell_48x48_24spp"])
def test_render_meets_golden(name):
    """`Renderer.render` against the JAX-made goldens, under `_check`'s
    limits with no floor."""
    mod = torch_sphere if name.startswith("sphere") else torch_cornell
    r = mod.renderer("cpu")
    img = r.render()
    assert img.shape == (r.height_, r.width_, 3) and img.dtype == np.uint8
    raw = r._last_buffer.raw()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy")).astype(np.float64)
    diff = np.abs(raw - ref)
    scale = max(ref.mean(), 1e-6)
    assert diff.mean() / scale < 0.015, diff.mean() / scale
    assert np.percentile(diff, 99) / scale < 0.12, np.percentile(diff, 99) / scale


def test_image_does_not_depend_on_chunking_or_sample_split(monkeypatch):
    """Per-pixel keys and absolute sample indices: 4 spp in one call, in
    two calls of 2 (`iterative_render`), and in 100-lane wavefronts give
    the same image (rtol 1e-5: CPU torch evaluates transcendental
    functions with vector code in the body of a tensor and scalar code in
    its tail, which may differ in the last bit)."""
    def image(chunk, interval):
        monkeypatch.setattr(trenderer, "PATH_CHUNK", chunk)
        r = torch_sphere.renderer("cpu", 16, 12, 4, 7)
        calls = []
        buf = r.iterative_render(interval, lambda i, b: calls.append(i))
        assert calls == list(range(interval, 5, interval))
        assert r.ray_counter.segments > 16 * 12 * 4 and r.ray_counter.seconds > 0
        return buf.raw()

    whole = image(1 << 18, 4)
    assert whole.mean() > 0
    np.testing.assert_allclose(image(1 << 18, 2), whole, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(image(100, 4), whole, rtol=1e-5, atol=1e-7)


def test_medium_scene_raises():
    """A scene with a medium no longer raises: `render` takes the media
    branch (`trace_volumetric`; `tests/test_torch_volumetric.py` holds it
    to `rpt_tpu`) and gives a finite, lit 8x8 image."""
    scene = torch_sphere.build_scene()
    scene.add(tr.Medium.homogeneous_isotropic(1e-4, 1e-3))
    r = tr.Renderer(scene, torch_sphere.camera(), device="cpu").width(8).height(8)
    img = r.render()
    assert img.shape == (8, 8, 3) and img.max() > 0
    assert np.isfinite(r._last_buffer.raw()).all() and r.ray_counter.segments >= 64
