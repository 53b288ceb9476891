"""`Renderer.profile` and the preview cut of the port's `Renderer`, on the
CPU: ``profile(dir)`` records the next ``sample`` call, writes a Chrome
trace and leaves the image bit-equal; `RPT_TPU_PREVIEW`,
`RPT_TPU_PREVIEW_SAMPLES` and `RPT_TPU_PREVIEW_PHOTONS` cut a render as
the JAX package's `Renderer` cuts it (`rpt_tpu/renderer.py:129-140`,
`:219-221`), in ``render``, ``iterative_render`` and ``photon_render``,
and never choose the device."""

import json
import os
import sys

import numpy as np
import pytest

import rpt_tpu as jr
import rpt_tpu_torch as tr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_sphere  # noqa: E402

PREVIEWS = [  # RPT_TPU_PREVIEW, _SAMPLES, _PHOTONS (None: unset)
    (None, None, None),
    ("32", "2", "2000"),
    ("4", None, None),
    ("1", "8", "100"),
    ("300", "1", "50000"),
]


class _Shot(Exception):
    """Stops a photon render at its shoot, carrying the photon count."""


def _stop_at_shoot(scene, tables, key, photon_count, *args, **kwargs):
    raise _Shot(photon_count)


def _scene(lib):
    scene = lib.Scene()
    scene.add(lib.Object(lib.sphere()))
    scene.add(lib.Light.Object(lib.Object(lib.sphere().translate((0.0, 4.0, 0.0))).material(
        lib.Material.light((1.0, 1.0, 1.0), 20.0))))
    return scene


def _cut(r, how, monkeypatch, photon_module):
    """(width, height, samples, photons) after ``how`` ran on ``r``: a
    photon render stopped at its shoot, a path render with its ``sample``
    replaced by a black one."""
    monkeypatch.setattr(photon_module, "shoot_photons_device", _stop_at_shoot)
    photons = None
    if how == "photon_render":
        with pytest.raises(_Shot) as shot:
            r.photon_render(30_000, "photon_map")
        photons = shot.value.args[0]
    else:
        monkeypatch.setattr(type(r), "sample", lambda self, n, buffer: buffer.add_samples(
            np.zeros((self.height_, self.width_, 3))))
        if how == "render":
            r.render()
        else:
            r.iterative_render(5, lambda i, b: None)
    return r.width_, r.height_, r.num_samples_, photons


@pytest.mark.parametrize("how", ["render", "iterative_render", "photon_render"])
@pytest.mark.parametrize("preview", PREVIEWS)
def test_preview_cut_matches_jax(preview, how, monkeypatch):
    from rpt_tpu.integrators import photon as jph
    from rpt_tpu_torch.integrators import photon as tph

    for name, value in zip(("RPT_TPU_PREVIEW", "RPT_TPU_PREVIEW_SAMPLES",
                            "RPT_TPU_PREVIEW_PHOTONS"), preview):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    cuts = []
    for lib, module in ((jr, jph), (tr, tph)):
        kwargs = {"device": "cpu"} if lib is tr else {}
        r = lib.Renderer(_scene(lib), lib.Camera(), **kwargs).width(800).height(600)
        with monkeypatch.context() as m:
            cuts.append(_cut(r.num_samples(100), how, m, module))
        if lib is tr:
            assert r.device.type == "cpu"
    assert cuts[1] == cuts[0]
    if preview[0] is not None and how == "render":
        assert cuts[1][:3] == (max(8, 800 // int(preview[0])), max(8, 600 // int(preview[0])),
                               min(100, int(preview[1] or 4)))


def test_preview_keeps_the_callers_device(monkeypatch):
    """A preview never moves a renderer to the CPU: the card stays the
    default, and raises here, where there is none."""
    monkeypatch.setenv("RPT_TPU_PREVIEW", "32")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.Renderer(_scene(tr), tr.Camera())


def test_profile_writes_a_trace_and_keeps_the_image(tmp_path):
    """``profile(dir)`` records the next sample only (one-shot); the image
    is bit-equal to an unprofiled render's."""
    plain = torch_sphere.renderer("cpu", 16, 12, 2, 7)
    plain.render()
    r = torch_sphere.renderer("cpu", 16, 12, 2, 7).profile(str(tmp_path / "trace"))
    r.render()
    assert np.array_equal(r._last_buffer.raw(), plain._last_buffer.raw())
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".trace.json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    r.render()
    assert os.listdir(tmp_path / "trace") == files
