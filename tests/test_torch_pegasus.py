"""The assets-and-sky slice as a whole on the CPU: `data/pegasus.obj`,
loaded by each package's own loader and decimated alike, in ice (ior
1.31) over a diffuse plane under the procedural sky, as
`examples/pegasus.py` and `examples/torch_pegasus.py` build it; 32x32, 2
spp, 4 bounces, seed 0. The port's per-sample launch (`_path_pass`)
against `rpt_tpu.renderer.build_launch` on the same keys, as
`tests/test_torch_path.py::test_trace_surface_matches_jax` does.

The mesh is cut from 100,138 to 16,383 triangles (`linspace` row
selection, as `examples/_assets.py::_preview_decimate` cuts it): at
16,384 the JAX package switches to its cluster tables, which take
minutes to compile on the CPU. The 32x32 wavefront stays under
`TILED_MIN_RAYS`, so the JAX package runs its exact `_traverse`.

Tolerances: `test_trace_surface_matches_jax`'s, per-pixel mean |diff| /
image mean <= 0.5% and image means within 0.5%. Rays refracted inside
the ice may flip a lane where a last-bit difference moves a grazing hit
(measured: 3.9e-7 and 2.5e-8).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

import rpt_tpu as jr
from rpt_tpu import io as jio
from rpt_tpu.renderer import build_launch
import rpt_tpu_torch as tr
from rpt_tpu_torch import renderer as trenderer
from rpt_tpu_torch.materials import TRANSMISSIVE

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import _assets  # noqa: E402
import _torch_assets  # noqa: E402
import torch_pegasus  # noqa: E402

PEGASUS = os.path.join(os.path.dirname(__file__), "..", "data", "pegasus.obj")
ROWS = 16383  # below rpt_tpu.scene.CLUSTERS_MIN_TRIS
SIZE, SPP, BOUNCES = 32, 2, 4


def _decimated(mesh, cls):
    sel = np.linspace(0, len(mesh) - 1, ROWS).astype(np.int64)
    return cls(mesh.vertices[sel], mesh.normals[sel])


def _jax_scene(mesh):
    """`examples/pegasus.py:9-17` with ``mesh``."""
    scene = jr.Scene()
    scene.add(_assets.get_hdri("birchwood_8k"))
    ice = jr.Material.transparent(jr.hex_color(0xF8F8FF), 1.31, 0.2)
    scene.add(jr.Object(mesh.scale((1.4, 1.4, 1.4))).material(ice))
    scene.add(jr.Object(jr.plane((0.0, 1.0, 0.0), -1.0)).material(
        jr.Material.diffuse(jr.hex_color(0xDDDDDD))))
    return scene


def test_pegasus_matches_jax():
    full = tr.load_obj(PEGASUS)
    assert len(full) == 100138
    jmesh = _decimated(jio.load_obj(PEGASUS), jr.Mesh)
    tmesh = _decimated(full, tr.Mesh)
    assert np.array_equal(jmesh.vertices, tmesh.vertices)
    assert np.array_equal(jmesh.normals, tmesh.normals)
    # the sky is the same map in both packages' helpers
    assert np.array_equal(_torch_assets.get_hdri("birchwood_8k")._buf,
                          _assets.get_hdri("birchwood_8k")._buf)

    jc = _jax_scene(jmesh).compile()
    cam = jr.Camera.look_at((-3.0, 2.0, 6.0), (0.0, 0.2, 0.0), (0.0, 1.0, 0.0), 0.6)
    fn = jax.jit(build_launch(jc, cam, SIZE, SIZE, BOUNCES, 32, SPP))
    ref = np.asarray(fn(jc.tables, jax.random.key(0), jnp.int32(0))).astype(np.float64)

    r = torch_pegasus.renderer("cpu", size=SIZE, sample=SPP,
                               scene=torch_pegasus.build_scene(tmesh))
    tc = r.compiled
    assert tc.n_tris == jc.n_tris == ROWS and isinstance(tc.environment, tr.Hdri)
    assert int(tc.tables["materials"].kind[0]) == TRANSMISSIVE
    got, segments = trenderer._path_pass(tc, r.camera, SIZE, SIZE, tr.sampling.key(0), 0, SPP,
                                         BOUNCES)
    assert np.isfinite(got).all() and got.mean() > 0
    scale = ref.mean()
    assert np.abs(got - ref).mean() / scale <= 0.005
    assert abs(got.mean() / scale - 1.0) <= 0.005
    # every pixel samples at least a camera segment; the sky lights the top row
    assert SIZE * SIZE * SPP < segments <= SIZE * SIZE * SPP * (BOUNCES + 1) * 2
    assert got.reshape(SIZE, SIZE, 3)[0].mean() > 0
