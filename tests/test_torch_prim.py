"""The analytic-primitive hit test of the port (K-prim's wrappers and its
plain version, the per-type chain of `ops/prim_hit.py`) against `rpt_tpu`,
on the CPU:

- `pack_prims`' rows against the scene's per-type tables;
- the port's `_prim_best`, `closest_hit` and `occluded` against the JAX
  package's on the fractal's first four levels (187 spheres and its
  plane: the JAX side takes its `fori_loop` branch), on
  `monomial_glass`' scene (every prim type, a monomial among them) and on
  ties between equal prims of every type;
- the CPU dispatch, bad rows and the kernel's parameter struct.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_prim.py -q
"""

import ctypes
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu as jr
from rpt_tpu import intersect as jint
from rpt_tpu.ray import Ray as JRay
from rpt_tpu.vec import Vec3 as JVec3
import rpt_tpu_torch as tr
from rpt_tpu_torch import intersect as tint
from rpt_tpu_torch import tracing
from rpt_tpu_torch.ops import _build
from rpt_tpu_torch.ops import prim_hit as ph
from rpt_tpu_torch.ray import Ray as TRay
from rpt_tpu_torch.vec import Vec3 as TVec3

N_RAYS = 512


def _fractal(pkg, levels=4):
    """`examples/fractal_spheres.py`'s scene cut to its first ``levels``
    levels (1, 6, 30, 150 spheres), each level one group, and its wall."""
    spheres = [[] for _ in range(levels)]

    def gen(p, rad, depth, last_dir):
        spheres[depth].append(pkg.sphere().scale((rad, rad, rad)).translate(tuple(p)))
        if depth == levels - 1:
            return
        disp = rad * 7.0 / 5.0
        dirs = [(disp, 0, 0), (-disp, 0, 0), (0, disp, 0), (0, -disp, 0), (0, 0, disp),
                (0, 0, -disp)]
        for i, d in enumerate(dirs):
            if last_dir is None or i != (last_dir ^ 1):
                gen(p + np.asarray(d), rad * 2.0 / 5.0, depth + 1, i)

    gen(np.zeros(3), 1.0, 0, None)
    scene = pkg.Scene()
    for i, group in enumerate(spheres):
        scene.add(pkg.Object(pkg.KdTree(group)).material(
            pkg.Material.specular(pkg.hex_color(0x264653 + 0x111111 * i), 0.25)))
    scene.add(pkg.Object(pkg.plane((0.0, 0.0, 1.0), -6.0)).material(
        pkg.Material.diffuse(pkg.hex_color(0xFFCCCC))))
    scene.add(pkg.Light.Point((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def _monomial_glass(pkg):
    """`examples/monomial_glass.py`'s objects (the sky left out): a monomial
    surface, a rotated cube, two spheres and a plane."""
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.monomial_surface(2.0, 4.0).translate((0.0, -1.0, 0.0))).material(
        pkg.Material.metallic(pkg.hex_color(0xFFFFFF), 0.0001)))
    scene.add(pkg.Object(
        pkg.cube().rotate_y(math.pi / 6.0).scale((0.5, 0.3, 0.4)).translate((0.4, -0.8, 4.0))
    ).material(pkg.Material.specular(pkg.hex_color(0xFF00FF), 0.5)))
    scene.add(pkg.Object(pkg.sphere().scale((0.5, 0.5, 0.5)).translate((1.5, -0.5, 1.0))).material(
        pkg.Material.specular(pkg.hex_color(0x0000FF), 0.1)))
    scene.add(pkg.Object(pkg.sphere().scale((0.5, 0.5, 0.5)).translate((-1.5, -0.5, 1.0)))
              .material(pkg.Material.specular(pkg.hex_color(0x00FF00), 0.1)))
    scene.add(pkg.Object(pkg.plane((0.0, 1.0, 0.0), -1.0)).material(
        pkg.Material.specular(pkg.hex_color(0xAAAAAA), 0.5)))
    scene.add(pkg.Light.Point((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def _ties(pkg):
    """Each prim type twice, the copies equal but for their material: the
    first of each pair must win every hit."""
    scene = pkg.Scene()
    for k in range(2):
        mat = pkg.Material.diffuse(pkg.hex_color(0x102030 * (k + 1)))
        scene.add(pkg.Object(pkg.sphere().scale((0.5, 0.5, 0.5)).translate((1.0, 0.0, 0.0)))
                  .material(mat))
        scene.add(pkg.Object(pkg.cube().translate((-1.0, 0.0, 0.0))).material(mat))
        scene.add(pkg.Object(pkg.plane((0.0, 1.0, 0.0), -1.0)).material(mat))
        scene.add(pkg.Object(pkg.monomial_surface(1.0, 4.0).translate((0.0, -0.5, 1.5)))
                  .material(mat))
    return scene


# name: (builder, centre and radius of the rays' targets, each material's
# prim size: the fractal's levels have radii 0.4^i, its wall is material 4)
SCENES = {"fractal": (_fractal, (0.0, 0.0, 0.0), 3.0, (1.0, 0.4, 0.16, 0.064, 1.0)),
          "monomial_glass": (_monomial_glass, (0.0, -0.5, 2.0), 2.5, (1.0,) * 5),
          "ties": (_ties, (0.0, 0.0, 0.5), 1.5, (1.0,) * 2)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(name, JAX compiled scene, port's compiled scene on the CPU, the
    JAX rays, the port's rays, limits): half the rays from a shell around
    the scene toward points inside it, half from the first half's hits
    (the port's) in random directions, with limits in [-0.5, 8)."""
    build, centre, radius, _ = SCENES[request.param]
    jc, tc = build(jr).compile(), build(tr).compile("cpu")
    rng = np.random.default_rng(17)
    m = N_RAYS // 2
    centre = np.asarray(centre)
    o = rng.normal(size=(m, 3))
    o = centre + 3.0 * radius * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = centre + rng.uniform(-radius, radius, (m, 3)) - o
    o, d = o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    first = tint.closest_hit(tc, tc.tables, TRay(TVec3.from_array(o), TVec3.from_array(d)))
    t = np.where(np.isfinite(first.time.numpy()), first.time.numpy(), 1.0)
    o2 = (o + d * t[:, None]).astype(np.float32)
    d2 = rng.normal(size=(m, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    limit = rng.uniform(-0.5, 8.0, N_RAYS).astype(np.float32)
    return (request.param, jc, tc, JRay(JVec3.from_array(o), JVec3.from_array(d)),
            TRay(TVec3.from_array(o), TVec3.from_array(d)), limit)


def test_scenes_pack_as_their_tables(scene):
    """The header counts the scene's prims by type, and each row holds its
    prim's transform, normal matrix, material and parameter exactly."""
    name, _, tc, _, _, _ = scene
    rows = tc.prim_rows
    assert rows.counts == (tc.n_spheres, tc.n_cubes, tc.n_planes, tc.n_monomials)
    assert rows.rows.shape == (sum(rows.counts), ph.ROW) and rows.rows.dtype == torch.float32
    if name == "fractal":
        assert rows.counts == (187, 0, 1, 0)
    if name == "monomial_glass":
        assert rows.counts == (2, 1, 1, 1)
    spheres = tc.tables["spheres"]
    lin = spheres.world_to_obj.linear
    assert torch.equal(rows.rows[: tc.n_spheres, 0], lin.m00)
    assert torch.equal(rows.rows[: tc.n_spheres, 11], spheres.world_to_obj.translation.z)
    assert torch.equal(rows.rows[: tc.n_spheres, 20], spheres.normal_mat.m22)
    assert torch.equal(rows.rows[: tc.n_spheres, ph.MATERIAL].to(torch.int32), spheres.material)
    plane_row = rows.rows[tc.n_spheres + tc.n_cubes]
    planes = tc.tables["planes"]
    assert torch.equal(plane_row[:4], torch.stack([planes.normal.x[0], planes.normal.y[0],
                                                   planes.normal.z[0], planes.value[0]]))


def test_prim_queries_match_jax(scene):
    """The port's `_prim_best`, `closest_hit` and `occluded` against the JAX
    package's, as `test_torch_scene_intersect.py::
    test_closest_hit_and_occluded_agree`: the same material on >= 99.9% of
    lanes (a float32 grazing hit may flip one), time within rtol 1e-5 and
    normals within atol 1e-5 where it agrees, and the same occlusion on
    >= 99.9% of lanes. The rays that leave a surface (the second half) may
    differ besides by 1e-6 of the scene's size: from a point on a sphere
    the quadratic's b = d.o cancels (|b| << |d||o|), so their time carries
    an absolute float32 error of the points' scale, which XLA and torch
    round differently (2.8e-5 relative at t = 0.065 on one fractal lane).
    A sphere's normal is its local hit point, o + d t in object space with
    |d| = 1 / radius, so the time's rtol 1e-5 moves it by up to 1e-5 t /
    radius: the normals' atol is 1e-5 (1 + t / size) with the size of the
    lane's prim (7.7e-4 on the fractal's radius-0.064 spheres at t ~ 8)."""
    name, jc, tc, jray, tray, limit = scene
    atol = np.where(np.arange(N_RAYS) < N_RAYS // 2, 0.0, 1e-6 * tc.scale)
    sizes = np.asarray(SCENES[name][3])
    for jh, th in ((jint._prim_best(jc, jc.tables, jray, jc.t_min),
                    tint._prim_best(tc, tc.tables, tray, tc.t_min)),
                   (jint.closest_hit(jc, jc.tables, jray), tint.closest_hit(tc, tc.tables, tray))):
        j_mat, t_mat = np.asarray(jh.material), th.material.numpy()
        same = j_mat == t_mat
        assert same.mean() >= 0.999
        j_t, t_t = np.asarray(jh.time), th.time.numpy()
        hit = same & np.isfinite(j_t)
        assert 0.3 < hit.mean() < 1.0
        assert (np.abs(t_t[hit] - j_t[hit]) <= 1e-5 * np.abs(j_t[hit]) + atol[hit]).all()
        n_tol = 1e-5 * (1.0 + np.abs(j_t[hit]) / sizes[j_mat[hit]])
        assert (np.abs(th.normal.to_numpy()[hit] - jh.normal.to_numpy()[hit]).max(axis=1)
                <= n_tol).all()
    j_occ = np.asarray(jint.occluded(jc, jc.tables, jray, jnp.asarray(limit)))
    t_occ = tint.occluded(tc, tc.tables, tray, torch.tensor(limit)).numpy()
    assert 0.05 < t_occ.mean() < 0.95
    assert (j_occ == t_occ).mean() >= 0.999


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_cpu_dispatch_runs_the_plain_version():
    """Rays on the CPU take the per-type chain (the same bits) and launch
    nothing; rays on another device than the CPU or a card, and rows with a
    bad header or layout, are refused; without a card a scene compiled for
    "cuda" raises, so no CUDA ray reaches the wrappers."""
    tc = _monomial_glass(tr).compile("cpu")
    rows = tc.prim_rows
    rng = np.random.default_rng(9)
    o = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ray = TRay(TVec3.from_array(o), TVec3.from_array(d))
    before = tracing.LAUNCHES.copy()
    got = ph.prim_closest_hit(rows, ray, tc.t_min)
    ref = ph.prim_closest_hit_plain(rows, ray, tc.t_min)
    assert torch.equal(_bits(got.time), _bits(ref.time)) and torch.equal(got.material,
                                                                        ref.material)
    limit = torch.tensor(rng.uniform(-1, 4, 300), dtype=torch.float32)
    assert torch.equal(ph.prim_any_hit(rows, ray, tc.t_min, limit),
                       ph.prim_any_hit_plain(rows, ray, tc.t_min, limit))
    assert torch.equal(tint.prim_occluded(tc, tc.tables, ray, limit),
                       tint._prim_best(tc, tc.tables, ray, tc.t_min).time < limit)
    assert tracing.LAUNCHES == before

    meta = ph.PrimRows(rows.rows.to("meta"), rows.counts, rows.sets)
    meta_ray = TRay(ray.origin.map(lambda c: c.to("meta")), ray.dir.map(lambda c: c.to("meta")))
    with pytest.raises(ValueError, match="unsupported device"):
        ph.prim_closest_hit(meta, meta_ray, tc.t_min)
    with pytest.raises(ValueError, match="unsupported device"):
        ph.prim_any_hit(meta, meta_ray, tc.t_min, 1.0)
    with pytest.raises(ValueError, match="the ray is on"):
        ph.prim_closest_hit(meta, ray, tc.t_min)
    for counts in ((2, 1, 1, 2), (2, 1, 1), (3, 1, 1, 1), (2, 1, 1, 0), (2, -1, 3, 1)):
        with pytest.raises(ValueError, match="header"):
            ph.prim_closest_hit(ph.PrimRows(rows.rows, counts, rows.sets), ray, tc.t_min)
    for bad in (rows.rows[:, :20], rows.rows.double(), rows.rows.t()):
        with pytest.raises(ValueError, match="rows must be"):
            ph.prim_any_hit(ph.PrimRows(bad, rows.counts, rows.sets), ray, tc.t_min, limit)
    with pytest.raises(ValueError, match="float32"):
        ph.prim_closest_hit(rows, TRay(ray.origin.map(torch.Tensor.double), ray.dir), tc.t_min)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _monomial_glass(tr).compile("cuda")


def test_scene_without_prims():
    """A scene with no analytic prim packs an empty table: every lane
    misses, nothing is occluded."""
    scene = tr.Scene()
    scene.add(tr.Light.Point((1.0, 1.0, 1.0), (0.0, 5.0, 5.0)))
    tc = scene.compile("cpu")
    assert tc.prim_rows.counts == (0, 0, 0, 0) and tc.prim_rows.rows.shape == (0, ph.ROW)
    ray = TRay(TVec3.from_array(np.zeros((5, 3), np.float32)),
               TVec3.from_array(np.tile(np.float32([0, 0, 1]), (5, 1))))
    hit = ph.prim_closest_hit(tc.prim_rows, ray, tc.t_min)
    assert bool(torch.isinf(hit.time).all()) and bool((hit.material == -1).all())
    assert not bool(ph.prim_any_hit(tc.prim_rows, ray, tc.t_min, 1.0).any())


def test_params_struct_matches_the_kernel():
    """`_PrimParams` has the layout that `csrc/prim_hit.cu` pins with its
    static_asserts, and the two entry points take it by reference."""
    with open(os.path.join(_build.CSRC_DIR, "prim_hit.cu")) as f:
        src = f.read()
    pinned = dict(re.findall(r"offsetof\(PrimParams, (\w+)\) == (\d+)", src))
    assert pinned and {k: int(v) for k, v in pinned.items()} == {
        k: getattr(ph._PrimParams, k).offset for k in pinned}
    assert int(re.search(r"sizeof\(PrimParams\) == (\d+)", src).group(1)) == \
        ctypes.sizeof(ph._PrimParams)
    assert int(re.search(r"constexpr int kRow = (\d+);", src).group(1)) == ph.ROW
    for name in ("rpt_prim_closest_hit", "rpt_prim_any_hit"):
        assert re.search(rf'extern "C" int {name}\(const PrimParams\* params, void\* stream\)',
                         src)
        assert _build._SIGNATURES[name] == [ctypes.c_void_p, ctypes.c_void_p]
