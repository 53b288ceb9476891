"""The port stands alone: every `rpt_tpu_torch` module imports without
jax, rpt_tpu, imageio or Pillow, and a CUDA device is never silently
replaced by the CPU."""

import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rpt_tpu_torch as tr

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "examples"))

import torch_cornell  # noqa: E402
import torch_dragon  # noqa: E402
import torch_marbles  # noqa: E402
import torch_pegasus  # noqa: E402
import torch_photon_map  # noqa: E402
import torch_sphere  # noqa: E402
import torch_teapot  # noqa: E402
import torch_volumetric_beambeam_lampshade as lampshade_beams  # noqa: E402
import torch_volumetric_beamphoton_lampshade as lampshade  # noqa: E402
import torch_volumetric_pathtrace_lampshade as lampshade_path  # noqa: E402
import torch_volumetric_photonphoton_lampshade as lampshade_map  # noqa: E402

EXAMPLES = ("torch_volumetric_beamphoton_lampshade", "torch_volumetric_photonphoton_lampshade",
            "torch_volumetric_beambeam_lampshade", "torch_volumetric_pathtrace_lampshade",
            "torch_dragon", "torch_sphere", "torch_cornell", "torch_photon_map",
            "torch_pegasus", "torch_teapot", "torch_marbles",
            "torch_skybox_photons", "torch_glass", "torch_metal", "torch_wine_glass",
            "torch_rustacean", "torch_lego", "torch_lighthouse", "torch_fractal_teapots",
            "torch_basic", "torch_spheres", "torch_compound", "torch_cornell_mirror",
            "torch_fractal_spheres", "torch_cylinder", "torch_monomial_glass",
            "torch_volumetric", "torch_skybox", "torch_simple_video")
# the drivers whose renderer() is called with no argument below
DRIVERS = EXAMPLES[11:]


def _modules():
    names = ["rpt_tpu_torch"]
    for info in pkgutil.walk_packages(tr.__path__, "rpt_tpu_torch."):
        names.append(info.name)
    return names


def test_modules_import_without_jax():
    names = _modules()
    assert {"rpt_tpu_torch.integrators.photon", "rpt_tpu_torch.ops.sphere_sweep",
            "rpt_tpu_torch.accel.knn", "rpt_tpu_torch.renderer",
            "rpt_tpu_torch.integrators.path", "rpt_tpu_torch.ops.bvh_traverse",
            "rpt_tpu_torch.meshes", "rpt_tpu_torch.medium", "rpt_tpu_torch.io",
            "rpt_tpu_torch.ode", "rpt_tpu_torch.environment",
            "rpt_tpu_torch.parallel"} <= set(names)
    found = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
             if f.startswith("torch_") and f.endswith(".py")}
    assert found == set(EXAMPLES)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"for name in {EXAMPLES!r}:\n"
        "    importlib.import_module(name)\n"
        "from rpt_tpu_torch.integrators.path import trace_volumetric\n"
        "from rpt_tpu_torch.integrators.photon import volume_estimate_beams, "
        "volume_estimate_point\n"
        "from rpt_tpu_torch import Medium\n"
        "assert callable(Medium.henyey_greenstein)\n"
        "import _torch_assets, _torch_skybox\n"
        "from rpt_tpu_torch.parallel import make_mesh, render_sharded\n"
        "_torch_assets.get_hdri('birchwood_8k')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'rpt_tpu', 'imageio', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(ROOT), os.path.abspath(os.path.join(ROOT, "examples"))]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = tr.Scene()
    scene.add(tr.Object(tr.sphere()))
    with pytest.raises(RuntimeError, match="cuda"):
        tr.Renderer(scene, tr.Camera(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.compile_scene(scene, "cuda")
    # the card is the default of every entry point
    with pytest.raises(RuntimeError, match="cuda"):
        tr.Renderer(scene, tr.Camera())
    with pytest.raises(RuntimeError, match="cuda"):
        tr.compile_scene(scene)
    with pytest.raises(RuntimeError, match="cuda"):
        scene.compile()
    # and of the examples' renderer helpers
    for make in (torch_sphere.renderer, torch_cornell.renderer, lampshade.renderer,
                 lampshade_map.renderer, lampshade_beams.renderer, lampshade_path.renderer,
                 torch_photon_map.renderer, lambda: torch_dragon.renderer(scene=scene),
                 lambda: torch_pegasus.renderer(scene=scene), torch_teapot.renderer,
                 torch_marbles.renderer, lambda: tr.ParticleState.of(np.zeros((1, 3)),
                                                                    np.zeros((1, 3)))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    for name in DRIVERS:
        with pytest.raises(RuntimeError, match="cuda"):
            importlib.import_module(name).renderer()
    # the CPU is an explicit choice, and the renderer records it
    assert tr.Renderer(scene, tr.Camera(), device="cpu").device.type == "cpu"


def test_examples_never_probe_for_a_card(monkeypatch):
    """No torch example asks whether CUDA is available: a run is on the
    card (and raises without one) unless it is a preview, which is on the
    CPU by choice (`preview_cut`), where the `Renderer` makes its own cut
    and the driver cuts only the work outside it (the dragon's mesh)."""
    for name in EXAMPLES:
        with open(os.path.join(ROOT, "examples", f"{name}.py")) as f:
            assert "is_available" not in f.read(), name
    monkeypatch.delenv("RPT_TPU_PREVIEW", raising=False)
    assert lampshade.preview_cut() == (None, "cuda")
    assert lampshade.preview_cut((660, 661), (48, 49)) == ((660, 661), "cuda")
    monkeypatch.setenv("RPT_TPU_PREVIEW", "32")
    assert lampshade.preview_cut() == (None, "cpu")
    assert lampshade.preview_cut((660, 661), (48, 49)) == ((48, 49), "cpu")


def test_sah_builder_source_is_the_ports_own_copy():
    """The port compiles its own copy of the SAH builder, never a file
    under `rpt_tpu/`: below its header comment the copy is the JAX
    package's source byte for byte."""
    from rpt_tpu_torch.accel import bvh

    pkg = os.path.realpath(os.path.dirname(tr.__file__))
    src = os.path.realpath(bvh.BVH_SOURCE)
    assert os.path.commonpath([pkg, src]) == pkg and os.path.isfile(src)

    def body(path):
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        first = next(i for i, line in enumerate(lines) if not line.startswith(b"//"))
        return b"\n".join(lines[first:])

    original = os.path.join(ROOT, "rpt_tpu", "native", "bvh_builder.cpp")
    assert body(src) == body(original) and b'extern "C"' in body(src)


def test_every_integrator_runs_on_the_cpu():
    """Every integrator is ported: `render()` works on the CPU (an 8x8
    sphere under a point light, 2 spp), with and without a medium, and so
    do the three photon kinds on a scene with an object light; nothing in
    the renderer, the photon integrator or the medium raises
    ``NotImplementedError``."""
    scene = tr.Scene()
    scene.add(tr.Object(tr.sphere()))
    scene.add(tr.Light.Point((50.0, 50.0, 50.0), (0.0, 5.0, 5.0)))
    r = tr.Renderer(scene, tr.Camera(), device="cpu").width(8).height(8).num_samples(2)
    img = r.render()
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8 and img.max() > 0
    assert np.isfinite(r._last_buffer.raw()).all()
    assert np.isfinite(r.scene.compile("cpu").t_min)
    with pytest.raises(RuntimeError, match="non-object lights"):
        r.photon_render(100, "photon_map")

    for fog in (None, tr.Medium.henyey_greenstein(1e-3, 1e-2, 0.5)):
        scene = tr.Scene()
        scene.add(tr.Object(tr.sphere()).material(tr.Material.diffuse((0.8, 0.8, 0.8))))
        scene.add(tr.Light.Object(tr.Object(tr.sphere().translate((0.0, 4.0, 0.0))).material(
            tr.Material.light((1.0, 1.0, 1.0), 20.0))))
        if fog is not None:
            scene.add(fog)
        r = (tr.Renderer(scene, tr.Camera(), device="cpu").width(8).height(8).num_samples(1)
             .gather_size(5).gather_size_volume(3).watts(100.0))
        renders = [r.render, lambda: r.photon_map_render(300),
                   lambda: r.photon_point_query_beam_render(300),
                   lambda: r.photon_beam_query_beam_render(300)]
        for render in renders:
            img = render()
            assert img.shape == (8, 8, 3) and np.isfinite(r._last_buffer.raw()).all()
    with pytest.raises(ValueError, match="unknown photon map kind"):
        r.photon_render(100, "beam_map")
    for name in ("renderer.py", "medium.py", os.path.join("integrators", "photon.py"),
                 os.path.join("integrators", "path.py")):
        with open(os.path.join(os.path.dirname(tr.__file__), name)) as f:
            assert "NotImplementedError" not in f.read(), name
