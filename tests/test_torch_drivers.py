"""The 18 torch drivers that complete the port's examples, against the
JAX examples they port, on the CPU: the renderer that each JAX example's
``main()`` builds (its render intercepted, as
`tests/test_torch_photon_map.py` does) carries the same parameters and
camera as the port driver's ``renderer()``, over a scene of the same
objects, lights, media and environment; and `torch_skybox_photons.py`'s
render (the open foggy box under the sky, photon map, `Renderer`'s default
gather of 50 / 50 over both clouds) meets the JAX example's.

Tolerances of the image (16x16, 1 spp, 4000 photons, seed 0): per-pixel
mean |diff| <= 0.005 of the mean radiance and the means within 0.005, the
photon-map limits of `tests/test_torch_photon_kinds.py`.
"""

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest

import rpt_tpu as jr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

FIELDS = ("width_", "height_", "exposure_value_", "stepsize_", "max_bounces_", "num_samples_",
          "gather_size_", "gather_size_volume_", "watts_", "seed_", "media_max_depth_")
CAMERA = ("eye", "direction", "up", "fov", "aperture", "focal_distance")
RENDERS = ("render", "iterative_render", "photon_map_render")
# driver: the photons its main() shoots (None: it path traces)
DRIVERS = {"skybox_photons": 10_000_000, "glass": None, "metal": None, "wine_glass": None,
           "rustacean": None, "lego": None, "lighthouse": None, "fractal_teapots": None,
           "basic": None, "spheres": None, "compound": None, "cornell_mirror": None,
           "fractal_spheres": None, "cylinder": None, "monomial_glass": None,
           "volumetric": None, "skybox": None, "simple_video": None}


def _jax_example(name, monkeypatch, tmp_path):
    """The renderer that the JAX example's ``main()`` builds (its first
    frame, for the video), how it renders and with what argument; the
    render and the save are intercepted."""
    jex = importlib.import_module(name)
    made = {}

    def capture(how):
        def render(self, *args):
            made.setdefault("renderer", (self, how, args))
            return np.zeros((self.height_, self.width_, 3), np.uint8)
        return render

    with monkeypatch.context() as m:
        m.delenv("RPT_TPU_PREVIEW", raising=False)
        m.setenv("RPT_TPU_FRAMES", "1")
        m.chdir(tmp_path)
        for how in RENDERS:
            m.setattr(jr.Renderer, how, capture(how))
        m.setattr(jex, "save", lambda img, path: None)
        jex.main()
    return made["renderer"]


def _shapes(shape, matrix=None):
    """A shape flattened, package-independently, into its leaves: (kind,
    4x4 transform, vertex sum of a mesh)."""
    matrix = np.eye(4) if matrix is None else matrix
    kind = type(shape).__name__
    if kind == "Transformed":
        return _shapes(shape.shape, np.asarray(shape.matrix) @ matrix)
    if kind == "ShapeGroup":
        return [leaf for s in shape.shapes for leaf in _shapes(s, matrix)]
    mesh = float(np.asarray(shape.vertices, np.float64).sum()) if kind == "Mesh" else 0.0
    return [(kind, matrix, mesh)]


def _assert_same_scene(t, j):
    """The same objects (shapes, transforms, meshes, materials), lights,
    media and environment."""
    def same(a_shape, b_shape, a_material, b_material):
        assert dataclasses.astuple(a_material) == dataclasses.astuple(b_material)
        la, lb = _shapes(a_shape), _shapes(b_shape)
        assert [k for k, _, _ in la] == [k for k, _, _ in lb]
        for (_, ma, va), (_, mb, vb) in zip(la, lb):
            np.testing.assert_allclose(ma, mb, rtol=1e-12, atol=1e-12)
            assert va == pytest.approx(vb, rel=1e-12)

    assert len(t.objects) == len(j.objects)
    for a, b in zip(t.objects, j.objects):
        same(a.shape, b.shape, a._material, b._material)
    assert [type(x).__name__ for x in t.lights] == [type(x).__name__ for x in j.lights]
    for a, b in zip(t.lights, j.lights):
        if type(a).__name__ == "ObjectLight":
            same(a.shape, b.shape, a.material, b.material)
        else:
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert len(t.media) == len(j.media)
    assert type(t.environment).__name__ == type(j.environment).__name__


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_carries_the_jax_examples_parameters(name, monkeypatch, tmp_path):
    j, how, args = _jax_example(name, monkeypatch, tmp_path)
    tex = importlib.import_module(f"torch_{name}")
    t = tex.renderer("cpu")
    assert t.device.type == "cpu"
    assert {f: getattr(t, f) for f in FIELDS} == {f: getattr(j, f) for f in FIELDS}
    assert t.filter_.radius == j.filter_.radius
    for f in CAMERA:
        assert getattr(t.camera, f) == getattr(j.camera, f), f
    _assert_same_scene(t.scene, j.scene)
    photons = DRIVERS[name]
    assert (how == "photon_map_render") == (photons is not None)
    if photons is not None:
        assert args == (photons,) and tex.PHOTONS == photons


def test_skybox_photons_render_matches_jax(monkeypatch, tmp_path):
    """16x16, 1 spp, 4000 photons through the JAX example's renderer and
    the port's (module docstring for the limits): both gathers at k = 50,
    the sky lit through the open ceiling."""
    import torch_skybox_photons as tex

    j, _, _ = _jax_example("skybox_photons", monkeypatch, tmp_path)
    j.width(16).height(16).num_samples(1).photon_map_render(4000)
    j_img = j._last_buffer.raw()
    t = tex.renderer("cpu", size=16, sample=1)
    img = t.photon_map_render(4000)
    t_img = t._last_buffer.raw()
    assert t.photon_map.kind == "photon_map" and t.photon_map.volume_grid.n > 0
    assert (t.gather_size_, t.gather_size_volume_) == (50, 50) and img.shape == (16, 16, 3)
    assert np.isfinite(t_img).all() and j_img.mean() > 0
    assert np.abs(t_img - j_img).mean() / j_img.mean() <= 0.005
    assert abs(t_img.mean() - j_img.mean()) / j_img.mean() <= 0.005
