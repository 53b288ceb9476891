"""Scene tables and ray queries of the port against `rpt_tpu` and the f64
oracle: the lampshade scene compiled by both packages, closest hit and
occlusion on random rays, and the on-plane guard (`tests/_oracle.py`)."""

import dataclasses
import os
import sys

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
from rpt_tpu_torch.ray import Ray as TRay
from rpt_tpu_torch.vec import Vec3 as TVec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
sys.path.insert(0, os.path.dirname(__file__))

import _lampshade  # noqa: E402
import _oracle as oracle  # noqa: E402
import torch_volumetric_beamphoton_lampshade as tlamp  # noqa: E402

WATTS = 200_000.0 / (130.0 * 105.0)


@pytest.fixture(scope="module")
def lampshade():
    js = _lampshade.build_scene(jr.Material.light(jr.hex_color(0xFFFEFA), WATTS))
    js.add(jr.Medium.homogeneous_isotropic(1e-4, 1e-3))
    ts = tlamp.build_scene(tr.Material.light(tr.hex_color(0xFFFEFA), WATTS))
    ts.add(tr.Medium.homogeneous_isotropic(1e-4, 1e-3))
    return js.compile(), ts.compile("cpu")


def _leaves(x, path="tables"):
    """Flatten a table tree (dataclasses, dicts, tuples, arrays) into
    (path, ndarray) pairs."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}[{k!r}]")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(x, torch.Tensor):
        yield path, x.numpy()
    else:
        yield path, np.asarray(x)


def test_lampshade_tables_agree(lampshade):
    jc, tc = lampshade
    for attr in ("n_spheres", "n_planes", "n_cubes", "n_monomials", "n_tris"):
        assert getattr(jc, attr) == getattr(tc, attr), attr
    assert jc.t_min == pytest.approx(tc.t_min, rel=1e-12)
    assert jc.scale == pytest.approx(tc.scale, rel=1e-12)
    assert [dataclasses.astuple(a) for a in jc.lights] == [dataclasses.astuple(b) for b in tc.lights]
    j_leaves = dict(_leaves(jc.tables))
    t_leaves = dict(_leaves(tc.tables))
    assert j_leaves.keys() == t_leaves.keys()
    for path, a in j_leaves.items():
        b = t_leaves[path]
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=path)


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([1.0, 1.0, -300.0], [555.0, 547.0, 558.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    limit = rng.uniform(0.0, 800.0, n).astype(np.float32)
    jray = JRay(JVec3.from_array(o), JVec3.from_array(d))
    tray = TRay(TVec3.from_array(o), TVec3.from_array(d))
    return jray, tray, limit


def test_closest_hit_and_occluded_agree(lampshade):
    """4096 random rays: same material and occlusion on >= 99.9% of lanes
    (f32 grazing hits may flip a lane), time within rtol 1e-5 where the
    materials agree."""
    jc, tc = lampshade
    jray, tray, limit = _random_rays(4096, 3)
    jh = jint.closest_hit(jc, jc.tables, jray)
    th = tint.closest_hit(tc, tc.tables, tray)
    j_mat, t_mat = np.asarray(jh.material), th.material.numpy()
    same = j_mat == t_mat
    assert same.mean() >= 0.999
    j_t, t_t = np.asarray(jh.time), th.time.numpy()
    hit = same & np.isfinite(j_t)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(t_t[hit], j_t[hit], rtol=1e-5)
    np.testing.assert_allclose(th.normal.to_numpy()[hit], jh.normal.to_numpy()[hit], atol=1e-5)

    j_occ = np.asarray(jint.occluded(jc, jc.tables, jray, jnp.asarray(limit)))
    t_occ = tint.occluded(tc, tc.tables, tray, torch.tensor(limit)).numpy()
    assert 0.05 < t_occ.mean() < 0.95
    assert (j_occ == t_occ).mean() >= 0.999


def test_dense_mesh_limit_raises():
    """Meshes beyond the dense triangle test (80 random triangles, 10 leaf
    rows) now take the BVH traversal: with an analytic sphere beside them,
    `closest_hit` and `occluded` agree with the JAX package's on >= 99.9%
    of 2048 random rays (f32 grazing hits may flip a lane), times within
    rtol 1e-5 where they agree; the sphere alone (`prim_occluded`)
    occludes a subset of the lanes that the scene occludes."""
    rng = np.random.default_rng(0)
    tris = rng.uniform(-1, 1, (80, 3, 3))
    normals = np.repeat(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])[:, None], 3, 1)
    compiled = []
    for pkg in (jr, tr):
        scene = pkg.Scene()
        scene.add(pkg.Object(pkg.Mesh(tris, normals)))
        scene.add(pkg.Object(pkg.sphere().scale((0.4, 0.4, 0.4)).translate((0.0, 1.2, 0.0))))
        compiled.append(scene.compile() if pkg is jr else scene.compile("cpu"))
    jc, tc = compiled
    assert tc.tables["bvh"].leaves.shape[0] > tint.DENSE_TRI_ROWS
    o = rng.uniform(-2, 2, (2048, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (2048, 3)) - o  # aimed into the soup
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    limit = rng.uniform(-0.5, 3.0, 2048).astype(np.float32)
    jray = JRay(JVec3.from_array(o), JVec3.from_array(d))
    ray = TRay(TVec3.from_array(o), TVec3.from_array(d))
    jh = jint.closest_hit(jc, jc.tables, jray)
    th = tint.closest_hit(tc, tc.tables, ray)
    j_t, t_t = np.asarray(jh.time), th.time.numpy()
    same = np.isfinite(j_t) == np.isfinite(t_t)
    assert same.mean() >= 0.999 and 0.5 < np.isfinite(t_t).mean() < 1.0
    hit = same & np.isfinite(j_t)
    np.testing.assert_allclose(t_t[hit], j_t[hit], rtol=1e-5)
    j_occ = np.asarray(jint.occluded(jc, jc.tables, jray, jnp.asarray(limit)))
    t_occ = tint.occluded(tc, tc.tables, ray, torch.tensor(limit)).numpy()
    assert 0.1 < t_occ.mean() < 0.9
    assert (j_occ == t_occ).mean() >= 0.999
    prim = tint.prim_occluded(tc, tc.tables, ray, torch.tensor(limit)).numpy()
    assert prim.any() and (t_occ >= prim).all()


def _floor_pairs(tc, n_points=512, n_pairs=4096, seed=5):
    """Points on the floor: f64 exact for the oracle, computed in f32 by
    the port's own camera-ray hits (coordinate noise ~eps*||p||)."""
    rng = np.random.default_rng(seed)
    target = np.zeros((n_points, 3))
    target[:, 0] = rng.uniform(-4.5, 4.5, n_points)
    target[:, 2] = rng.uniform(-4.5, 4.5, n_points)
    eye = np.array([0.3, 8.0, -9.0])
    d = target - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = TRay(TVec3.from_array(np.tile(eye, (n_points, 1))), TVec3.from_array(d))
    hit = tint.closest_hit(tc, tc.tables, ray)
    on_floor = hit.material.numpy() == 0
    p32 = ray.at(hit.time).to_numpy()
    i = rng.integers(0, n_points, n_pairs)
    j = rng.integers(0, n_points, n_pairs)
    keep = (i != j) & on_floor[i] & on_floor[j]
    return target[i[keep]], target[j[keep]], p32[i[keep]], p32[j[keep]]


def _visibility_oracle_vs_port(tc, o_scene):
    a64, b64, a32, b32 = _floor_pairs(tc)
    disp = b64 - a64
    dist = np.linalg.norm(disp, axis=1)
    occ_oracle = o_scene.occluded(a64, disp / dist[:, None], dist * (1.0 - tc.shadow_eps))
    disp32 = (b32 - a32).astype(np.float32)
    dist32 = np.linalg.norm(disp32, axis=1).astype(np.float32)
    ray = TRay(TVec3.from_array(a32), TVec3.from_array(disp32 / dist32[:, None]))
    occ_port = tint.occluded(tc, tc.tables, ray,
                             torch.tensor(dist32 * np.float32(1.0 - tc.shadow_eps))).numpy()
    return occ_oracle, occ_port


def test_on_plane_guard_matches_oracle(monkeypatch):
    """Visibility between points ON a mesh floor, with a sphere sunk into
    it: the f64 oracle (exact points) against the port (points computed
    in f32). Without `_origin_on_plane` the grazing floor rays are
    self-occluded (the JAX package's round-4 fault)."""
    scene = tr.Scene()
    floor = tr.polygon([(-5, 0, -5), (-5, 0, 5), (5, 0, 5), (5, 0, -5)])
    scene.add(tr.Object(floor).material(tr.Material.diffuse((0.5, 0.5, 0.5))))
    scene.add(tr.Object(tr.sphere().translate((0.0, 0.5, 0.0))).material(
        tr.Material.diffuse((0.2, 0.2, 0.2))))
    tc = scene.compile("cpu")
    verts = np.asarray(floor.vertices, np.float64)
    o_scene = oracle.OScene(
        objects=[oracle.OTris(verts, oracle.OMat()),
                 oracle.OSphere((0.0, 0.5, 0.0), 1.0, oracle.OMat())],
        lights=[],
    )
    occ_oracle, occ_port = _visibility_oracle_vs_port(tc, o_scene)
    assert len(occ_oracle) > 3000
    assert 0.05 < occ_oracle.mean() < 0.95  # the sphere blocks some pairs
    assert (occ_oracle == occ_port).mean() >= 0.999

    monkeypatch.setattr(tint, "_origin_on_plane", lambda num, pn, v1, o: torch.zeros_like(num, dtype=torch.bool))
    _, occ_unguarded = _visibility_oracle_vs_port(tc, o_scene)
    assert (occ_oracle == occ_unguarded).mean() < 0.95


@pytest.mark.parametrize("n", [12, 200])
def test_bvh_build_matches_jax(n):
    """Both packages build the same tree over the same boxes: the numpy
    LBVH at or below two leaves, the native SAH builder above."""
    from rpt_tpu.accel.bvh import build_bvh as jax_build_bvh
    from rpt_tpu_torch.accel.bvh import build_bvh

    rng = np.random.default_rng(n)
    lo = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 5, (n, 3)).astype(np.float32)
    got, ref = build_bvh(lo, hi), jax_build_bvh(lo, hi)
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, field.name), getattr(ref, field.name),
                                      err_msg=field.name)
