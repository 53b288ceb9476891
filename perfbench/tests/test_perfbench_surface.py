"""CPU tests of the pegasus configuration's own pieces: the benchmark's OBJ
parser against the port's loader, the frozen sky against the examples'
map, and the surface reference's sky lookup and transmissive bounce
against the port's `Hdri.get_color` and `materials.sample_f`, lane for
lane."""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)
sys.path.insert(0, os.path.join(CHECKOUT, "examples"))

import rpt_tpu_torch as rpt  # noqa: E402
from rpt_tpu_torch import materials  # noqa: E402
from rpt_tpu_torch.vec import Vec3  # noqa: E402
from perfbench.harness import spec  # noqa: E402
from perfbench.reference import rng, surface  # noqa: E402

pegasus = spec.module("scenes", "pegasus")
PEGASUS = os.path.join(CHECKOUT, "data", "pegasus.obj")


def _vec(a: torch.Tensor) -> Vec3:
    """(n, 3) as the port holds a vector: three contiguous components."""
    return Vec3(*(c.contiguous() for c in a.unbind(-1)))


def _arr(v: Vec3) -> torch.Tensor:
    return torch.stack([v.x, v.y, v.z], -1)


def test_the_obj_parser_reads_the_pegasus_as_the_port_loads_it():
    vertices, normals = pegasus.parse_obj(PEGASUS)
    mesh = rpt.load_obj(PEGASUS)
    assert len(vertices) == len(mesh) == 100_138
    assert np.array_equal(vertices, mesh.vertices)
    assert np.array_equal(normals, mesh.normals)


def test_the_obj_parser_fans_faces_and_resolves_indices_as_the_port(tmp_path):
    path = tmp_path / "faces.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nvn 0 0 1\nvn 0 0.6 0.8\n"
                    "f 1//1 2//1 3//2 4//2\n# a comment\nf -4 -2 -1\nf 2/7/1 3/7/2 4/7/1\n")
    vertices, normals = pegasus.parse_obj(str(path))
    mesh = rpt.load_obj(str(path))
    assert len(vertices) == 4
    assert np.array_equal(vertices, mesh.vertices)
    assert np.array_equal(normals, mesh.normals)


def test_the_frozen_sky_is_the_examples_map():
    import _torch_assets

    assert np.array_equal(pegasus.sky(), _torch_assets.get_hdri("birchwood_8k")._buf)


def _sky_scene():
    sc = surface.SurfaceScene.__new__(surface.SurfaceScene)  # the sky alone, no geometry
    sky = pegasus.sky()
    sc.sky_h, sc.sky_w = sky.shape[:2]
    sc.sky = torch.tensor(sky.reshape(-1, 3), dtype=torch.float32)
    return sc, rpt.Hdri(sky)


def test_the_sky_lookup_is_the_ports_at_the_seam_the_poles_and_the_last_row_and_column():
    sc, hdri = _sky_scene()
    g = torch.Generator().manual_seed(11)
    special = torch.tensor([
        [-1.0, 0.0, 0.0], [-1.0, 0.0, -0.0], [-1.0, 0.3, 1e-7], [-1.0, -0.3, -1e-7],  # the seam
        [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1e-6, -1.0, 1e-6], [-1e-6, 1.0, 0.0],  # the poles
        [-1.0, -1e-3, -1e-9], [-0.2, -1.0, 1e-3], [0.5, -2.0, -0.1],  # last column and row
        [3.0, 4.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    d = torch.cat([special, torch.randn(4096, 3, generator=g)]).float()
    ours = surface.sky_color(sc, d)
    port = _arr(hdri.get_color(hdri.tables(), _vec(d)))
    assert torch.equal(ours, port)
    x = (torch.atan2(d[:, 2], d[:, 0]) + math.pi) / (2 * math.pi) * (sc.sky_w - 1)
    y = torch.acos(torch.clamp(surface.normalize(d)[:, 1], -1, 1)) / math.pi * (sc.sky_h - 1)
    assert (x.to(torch.int32) == sc.sky_w - 1).any() and (y.to(torch.int32) == sc.sky_h - 1).any()


def test_the_transmissive_bounce_is_the_ports_with_total_internal_reflection():
    n = 8192
    g = torch.Generator().manual_seed(5)
    normal = surface.normalize(torch.randn(n, 3, generator=g))
    wo = surface.normalize(torch.randn(n, 3, generator=g))  # half the lanes inside the ice
    keys = rng.fold_in(rng.key(3_000_000_019), torch.arange(n))
    kind = torch.full((n,), surface.TRANSMISSIVE, dtype=torch.int32)
    kind[::4] = materials.LAMBERTIAN
    ior = torch.full((n,), 1.31)
    albedo, zero = torch.full((n, 3), 0.5), torch.zeros(n)
    lanes = materials.MaterialLanes(kind, _vec(albedo), zero, zero, ior)
    wi_p, pdf_p, ok_p = materials.sample_f(lanes, _vec(normal), _vec(wo), keys)
    wi, pdf, ok = surface.sample_f(kind.long(), albedo, zero, ior, normal, wo, keys)
    assert torch.equal(wi, _arr(wi_p)) and torch.equal(pdf, pdf_p) and torch.equal(ok, ok_p)
    glass = kind == surface.TRANSMISSIVE
    inside = surface.dot(normal, wo) < 0
    assert (~ok & glass & inside).sum() > 100 and (ok & glass & inside).sum() > 100
    f_p = materials.bsdf(lanes, _vec(normal), _vec(wo), wi_p)
    f = surface.bsdf(kind.long(), albedo, zero, normal, wo, wi)
    assert torch.equal(f, _arr(f_p))
    assert (f[glass] == 1.0).all(-1).any() and (f[glass] == 0.0).all(-1).any()


@pytest.mark.parametrize("keep,rows", [(100_138, None), (3, [0, 50_068, 100_137])])
def test_a_configuration_keeps_the_whole_mesh_or_linspace_rows(keep, rows):
    got = pegasus._rows(100_138, keep)
    assert (got is None) if rows is None else got.tolist() == rows
    with pytest.raises(ValueError):
        pegasus._rows(100_138, 100_139)
