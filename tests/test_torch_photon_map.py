"""`examples/torch_photon_map.py`, the port's driver of
`examples/photon_map.py`, against the JAX example on the CPU: the renderer
that the JAX example's ``main()`` builds (its render intercepted) carries
the same parameters as the port's, and both render its scene, gather at
`Renderer`'s defaults (50 / 50), to the same image at a small size.

Tolerances (16x16, 1 spp, 4000 photons, seed 0): per-pixel mean |diff|
<= 0.005 of the mean radiance and the means within 0.005, the limits that
`tests/test_torch_photon_kinds.py` holds the photon-map kind to, both
with the port's own exact k-NN and with `knn_query` replaced by the JAX
package's grid k-NN over the same points (measured on the CPU: 0.0015 and
0.00005; 0.0014 and 0.00006). At this size the JAX grid answers 3 of the
238 gather lanes that hit with a non-exact 50-NN (k-th d^2 up to 1.09x):
the exact k-NN moves the per-pixel difference by 0.0001.
"""

import os
import sys

import numpy as np

import rpt_tpu as jr
from rpt_tpu_torch.integrators import photon as tph

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import photon_map as jex  # noqa: E402
import torch_photon_map as tex  # noqa: E402
from test_torch_photon import _jax_grid_knn  # noqa: E402

FIELDS = ("width_", "height_", "exposure_value_", "max_bounces_", "num_samples_", "gather_size_",
          "gather_size_volume_", "watts_", "seed_")


def _jax_example(monkeypatch):
    """The JAX example's renderer and photon count, as its ``main()``
    builds them; the render and the save are intercepted."""
    made = {}

    def capture(self, photon_count):
        made["renderer"], made["photons"] = self, photon_count
        return np.zeros((self.height_, self.width_, 3), np.uint8)

    with monkeypatch.context() as m:
        m.delenv("RPT_TPU_PREVIEW", raising=False)
        m.setattr(jr.Renderer, "photon_map_render", capture)
        m.setattr(jex, "save", lambda img, path: None)
        jex.main()
    return made["renderer"], made["photons"]


def test_renderer_carries_the_jax_examples_parameters(monkeypatch):
    j, photons = _jax_example(monkeypatch)
    t = tex.renderer("cpu")
    assert {f: getattr(t, f) for f in FIELDS} == {f: getattr(j, f) for f in FIELDS}
    assert t.filter_.radius == j.filter_.radius == 1
    assert (t.width_, t.num_samples_, t.max_bounces_) == (512, 10, 5)
    assert (t.gather_size_, t.gather_size_volume_) == (50, 50)  # the defaults
    assert photons == tex.photons == 10_000_000
    for f in ("eye", "direction", "up", "fov", "aperture", "focal_distance"):
        assert getattr(t.camera, f) == getattr(j.camera, f), f
    assert not t.compiled.media


def test_render_matches_jax(monkeypatch):
    """16x16, 1 spp, 4000 photons through the JAX example's renderer and
    the port's, the port's with its own exact k-NN and then with the JAX
    package's (module docstring for the limits); one JAX render for
    both."""
    j, _ = _jax_example(monkeypatch)
    j.width(16).height(16).num_samples(1).photon_map_render(4000)
    j_img = j._last_buffer.raw()
    assert j_img.mean() > 0
    for jax_knn in (False, True):
        if jax_knn:
            monkeypatch.setattr(tph, "knn_query", _jax_grid_knn)
        t = tex.renderer("cpu", size=16, sample=1)
        img = t.photon_map_render(4000)
        t_img = t._last_buffer.raw()
        assert t.photon_map.kind == "photon_map" and t.photon_map.volume_grid.n == 0
        assert t.gather_size_ == 50 and img.shape == (16, 16, 3)
        assert np.isfinite(t_img).all() and t_img.mean() > 0
        pixel = np.abs(t_img - j_img).mean() / j_img.mean()
        mean = abs(t_img.mean() - j_img.mean()) / j_img.mean()
        assert pixel <= 0.005, (jax_knn, pixel)
        assert mean <= 0.005, (jax_knn, mean)

