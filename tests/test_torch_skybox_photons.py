"""The skybox_photons deployment of the benchmark on the CPU: the port's
point-photon x point-query photon-map render of the open foggy box under
the sky (`Renderer.photon_map_render`, both gathers at k = 50, the
occlusion recheck) against the plain reference
`perfbench/reference/pointquery.py` at every pixel; the point-query
estimator on a hand-built cloud of known density; the scene module's
renderer against `examples/torch_skybox_photons.renderer`; the spans of
the point-query pass; and the reference's imports.

The render is cut to 16x16 pixels, 2 samples and 20,000 photons (the
renders loop's watts x photons kept at the example's 100 W); the fog,
both k = 50 gathers and the recheck stay.
"""

import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

import rpt_tpu_torch as rpt
from rpt_tpu_torch import sampling, tracing
from rpt_tpu_torch.accel import knn
from rpt_tpu_torch.integrators import photon as port_photon
from rpt_tpu_torch.ray import Hit, Ray
from rpt_tpu_torch.vec import Vec3

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, CHECKOUT)
sys.path.insert(0, os.path.join(CHECKOUT, "examples"))

from perfbench import run  # noqa: E402
from perfbench.harness import check, spec  # noqa: E402
from perfbench.reference import pointquery  # noqa: E402

SEED = 5_000_000_029
PHOTONS = 20_000
TINY = {"width": 16, "height": 16,
        "settings": {"photonmap": {"photons": PHOTONS, "samples": 2, "watts": 100.0 / PHOTONS}}}
scene_module = spec.module("scenes", "skybox_photons")


def _desc(overrides=TINY):
    cell = spec.cell(spec.benchmark(), "skybox_photons.render")
    config = run._merge(cell["config"], overrides)
    return scene_module.describe(config, config["settings"]["photonmap"], SEED)


@pytest.fixture(scope="module")
def rendered():
    """The port's render at the cut size, as the renders loop drives it,
    recorded under a CPU profiler, with every `knn_query` call of the
    photon integrator counted as a launch (the CPU path launches nothing):
    ``(renderer, desc, spans)``."""
    desc = _desc()
    renderer = scene_module.build_renderer(desc, SEED, "cpu")
    loop = spec.module("traffic", "renders")
    loop._configure(renderer, desc["render"])
    real = port_photon.knn_query

    def counted(*args, **kwargs):
        tracing.count("knn_query")
        return real(*args, **kwargs)

    tracing.clear()
    with pytest.MonkeyPatch.context() as m:
        # the process's table back as it was after the render
        m.setattr(tracing, "LAUNCHES", tracing.LAUNCHES.copy())
        m.setattr(port_photon, "knn_query", counted)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            loop._render(renderer, desc["render"])
    spans = tracing.spans()
    tracing.clear()
    return renderer, desc, spans


def test_the_ports_render_is_the_plain_references_at_every_pixel(rendered):
    """On the CPU the port's k-NN is brute force (`knn_plain`) and the
    reference's is its exact grid search: both find the same 50 photons in
    the same order, and both sum them, the samples and the branches in the
    same float32 order, so the two images agree to rounding: rtol 1e-5,
    the photon reference's CPU limit (`perfbench/tests`). The reference
    computed in bfloat16, one precision below the float32 the renderer
    states, misses it on most lit pixels."""
    renderer, desc, _ = rendered
    assert renderer.photon_map.kind == "photon_map"
    assert (renderer.gather_size_, renderer.gather_size_volume_) == (50, 50)
    assert renderer.photon_map.surface_grid.n > 50 and renderer.photon_map.volume_grid.n > 50
    program = renderer._last_buffer.sum.reshape(-1, 3)
    pixels = np.arange(desc["width"] * desc["height"])
    reference = pointquery.render_pixels(desc, SEED, pixels, "cpu")
    lit = (reference != 0).any(-1)
    assert lit.mean() > 0.3 and np.isfinite(program).all()
    np.testing.assert_allclose(program, reference, rtol=1e-5, atol=1e-12)
    control = pointquery.render_pixels(desc, SEED, pixels, "cpu", dtype=torch.bfloat16)
    off = ~np.isclose(control, reference, rtol=1e-5, atol=1e-12).all(-1)
    assert off[lit].mean() > 0.5
    assert check.mismatch_share(control, reference, 1e-4, 1e-7) > 0.5


def _lattice_free_cloud(n, side, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 3, generator=g, dtype=torch.float64).float() * side


def test_the_point_query_estimate_on_a_cloud_of_known_density():
    """120,000 photons of equal power spread uniformly over a cube of side
    100 (density 0.12), queries drawn near its centre by free flights of
    mean length 1: each lane's estimate is k p c / (4 pi) / ((4/3) pi
    r_k^3) / sigma_t^2 (the transmittance over the free flight's pdf is 1
    / sigma_t) with r_k the exact 50th distance; their mean is the cloud's
    density times p c / (4 pi sigma_t^2) within 5% (k / V_k overestimates
    a Poisson density by k / (k - 1), 2%; 400 queries of 50 photons each
    leave ~1% of noise); and the reference's estimator gives the same."""
    n, side, k, power = 120_000, 100.0, 50, 0.25
    points = _lattice_free_cloud(n, side, 3)
    rows = torch.zeros((n, port_photon.PHOTON_ROW), dtype=torch.float32)
    rows[:, 0:3] = points
    rows[:, 3] = 1.0
    rows[:, 6:9] = power
    grid = knn.build_grid(rows[:, 0:3].contiguous())
    empty = knn.build_grid(torch.zeros((0, 3), dtype=torch.float32))
    pmap = port_photon.PhotonMapData(port_photon.PHOTON_MAP, empty,
                                     torch.zeros((0, port_photon.PHOTON_ROW)), grid,
                                     rows[grid.order])
    m = 400
    g = torch.Generator().manual_seed(4)
    origin = (torch.rand(m, 3, generator=g) * 40.0 + 30.0).float()
    direction = torch.nn.functional.normalize(torch.randn(m, 3, generator=g), dim=1).float()
    ray = Ray(Vec3.from_array(origin), Vec3.from_array(direction))
    medium = rpt.Medium.homogeneous_isotropic(0.5, 0.5)
    keys = sampling.keys_for(sampling.key(11), m)
    out = port_photon.volume_estimate_point(None, None, pmap, medium, ray, Hit.none((m,)), keys,
                                            k, k).to_array().double()

    d, d_pdf, _ = medium.sample_d(ray, sampling.key_path(keys).fold(0x7))
    collision = ray.at(d).to_array()
    assert (collision > 5.0).all() and (collision < side - 5.0).all()
    d2, _ = torch.topk(((points.double()[None] - collision.double()[:, None]) ** 2).sum(-1), k,
                       largest=False)
    tan = np.asarray(rpt.hex_color(0xD2B48C).to_numpy(), np.float64)
    ext = 0.5 + 0.5
    r3 = d2[:, -1] ** 1.5
    expected = (k * power / (4 * math.pi) / (4.0 / 3.0 * math.pi * r3) / ext**2)[:, None] \
        * torch.tensor(tan)[None]
    np.testing.assert_allclose(out.numpy(), expected.numpy(), rtol=1e-4)
    known = n / side**3 * power / (4 * math.pi) / ext**2 * tan
    np.testing.assert_allclose(out.mean(0).numpy(), known, rtol=0.05)

    ref = pointquery._volume(rows, collision, torch.full((m,), 0.5) + torch.full((m,), 0.5),
                             d, d_pdf,
                             torch.tensor(tan, dtype=torch.float32), k)
    np.testing.assert_allclose(ref.double().numpy(), out.numpy(), rtol=1e-5)


def _same(a, b, where="") -> int:
    """Tensors, numbers and containers of the two compiled scenes' tables
    equal, recursively; the number of tensors compared."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
        return 1
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        return sum(_same(a[key], b[key], f"{where}.{key}") for key in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        return sum(_same(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    if hasattr(a, "__dataclass_fields__") or hasattr(a, "__dict__"):
        assert type(a) is type(b), where
        fields = getattr(a, "__dataclass_fields__", None) or vars(a)
        return sum(_same(getattr(a, f), getattr(b, f), f"{where}.{f}") for f in fields)
    assert a == b, where
    return 0


def test_the_scene_modules_renderer_is_the_examples():
    import torch_skybox_photons as example

    desc = _desc({})
    ours = scene_module.build_renderer(desc, 0, "cpu")
    theirs = example.renderer("cpu")
    for field in ("width_", "height_", "exposure_value_", "filter_", "max_bounces_",
                  "media_max_depth_", "gather_size_", "gather_size_volume_", "watts_", "seed_"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.camera == theirs.camera
    a, b = ours.compiled, theirs.compiled
    for field in ("n_spheres", "n_planes", "n_cubes", "n_monomials", "n_tris", "lights",
                  "environment", "t_min", "shadow_eps", "scale", "nee_mode"):
        assert getattr(a, field) == getattr(b, field), field
    assert (a.n_tris, a.n_cubes, len(a.lights)) == (20, 2, 1)
    assert _same(a.tables, b.tables, "tables") >= 20
    assert _same(a.prim_rows, b.prim_rows, "prim_rows") >= 1
    (ma,), (mb,) = a.media, b.media
    at = Vec3.from_array(torch.tensor([[278.0, 273.0, 0.0]]))
    for name in ("absorption", "scattering", "emission"):
        assert torch.equal(getattr(ma, name)(at), getattr(mb, name)(at)), name
    assert ma.phase_const == mb.phase_const
    assert torch.equal(ma.color(at).to_array(), mb.color(at).to_array())
    assert desc["render"] == {"integrator": "photon_map", "samples": 100,
                              "photons": 10_000_000, "gather_size": 50,
                              "gather_size_volume": 50, "watts": 1e-05}
    assert desc["render"]["watts"] * desc["render"]["photons"] == pytest.approx(theirs.watts_,
                                                                                rel=1e-15)


def test_the_point_query_pass_has_its_spans(rendered):
    """`photon.build` records the deposits it sorts; each camera wavefront's
    `photon.estimate` holds its closest-hit query, then the volume gather
    (`photon.gather_volume`) and the surface gather (`photon.gather`), one
    K-knn launch each, then the recheck: the children the benchmark's
    `photon.volume_point_ms` subtracts from and leaves in the estimate."""
    renderer, desc, spans = rendered
    (build,) = [s for s in spans if s.name == "photon.build"]
    counts = renderer.photon_counts
    assert build.lanes == counts["surface"] + counts["volume"]
    estimates = [s for s in spans if s.name == "photon.estimate"]
    assert len(estimates) == desc["render"]["samples"]  # one wavefront a sample at 16x16
    for est in estimates:
        kids = sorted((s for s in spans if s.parent == est.id), key=lambda s: s.start_ns)
        names = [s.name for s in kids]
        assert names == ["intersect.closest", "photon.gather_volume", "photon.gather",
                         "photon.occlusion"]
        for gather in kids[1:3]:
            assert gather.launches == {"knn_query": 1}
    gathers = [s for s in spans if s.name in ("photon.gather", "photon.gather_volume")]
    assert len(gathers) == 2 * len(estimates)


def _imports(path):
    tree = ast.parse(open(path).read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(0, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module is None:  # from . import rng
            out += [(node.level, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.level, node.module))
    return out


def test_the_reference_imports_nothing_of_the_port_or_jax():
    """`pointquery.py` and the reference modules it reads: their imports,
    read from the source, name neither the port, the JAX package nor JAX."""
    ref_dir = os.path.join(CHECKOUT, "perfbench", "reference")
    todo, seen = ["pointquery"], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for level, module in _imports(os.path.join(ref_dir, name + ".py")):
            top = module.split(".")[0]
            if level:
                assert level == 1 and top in {"rng", "path", "photon", "scene"}, module
                todo.append(top)
            else:
                assert top not in {"rpt_tpu", "rpt_tpu_torch", "jax", "jaxlib", "flax"}, module
    assert seen == {"pointquery", "rng", "path", "photon", "scene"}
