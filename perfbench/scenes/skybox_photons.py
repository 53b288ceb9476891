"""The open-ceiling foggy Cornell box of `examples/skybox.rs:10-110` as
plain data (a frozen copy of `examples/_torch_skybox.py::build_scene`),
and the port's `Renderer` built from it, as
`examples/torch_skybox_photons.py` builds it.

A box 1,409 units deep (z from -850 to 559.2) whose ceiling has a hole
around x 263-293, z 227-332; a light of emittance 50,000 500 units above
the hole, shifted (-50, 0, 50), the only light; two white boxes inside; a
sky-blue `ColorEnvironment`; a homogeneous isotropic fog; a box filter
of radius 1. Twenty triangles in all: the floor, the four pieces of the
ceiling, four walls and the light, each polygon fanned (shape.rs:307-314).
"""

from __future__ import annotations

import math

import numpy as np

from ._common import color, transform
from .lampshade import _polygon


def _polygons() -> list:
    """``(colour, points, transform)`` of every polygon, in the order
    `_torch_skybox.build_scene` adds them: the floor, the four pieces of the
    ceiling, the back, front, left and right walls; the light last."""
    p1 = np.array([343.0 - 50.0, 548.9, 227.0])
    p2 = np.array([343.0 - 50.0, 548.9, 332.0])
    p3 = np.array([213.0 + 50.0, 548.9, 332.0])
    p4 = np.array([213.0 + 50.0, 548.9, 227.0])
    c1 = np.array([0.0, 548.9, -850.0])
    c2 = np.array([556.0, 548.9, -850.0])
    c3 = np.array([556.0, 548.9, 559.2])
    c4 = np.array([0.0, 548.9, 559.2])
    br = np.array([p3[0], c4[1], c4[2]])
    bl = np.array([p2[0], c3[1], c3[2]])
    fr = np.array([p4[0], c1[1], c1[2]])
    fl = np.array([p1[0], c2[1], c2[2]])
    shift = np.array([0.0, 500.0, 0.0])
    return [
        ("white", [(0, 0, -850.0), (0, 0, 559.2), (556, 0, 559.2), (556, 0, -850.0)], []),
        ("white", [c1, fr, br, c4], []),
        ("white", [p3, p2, bl, br], []),
        ("white", [fl, c2, c3, bl], []),
        ("white", [fr, fl, p1, p4], []),
        ("white", [(0, 0, 559.2), (0, 548.9, 559.2), (556, 548.9, 559.2), (556, 0, 559.2)], []),
        ("white", [(0, 0, -850.0), (556, 0, -850.0), (556, 548.9, -850.0), (0, 548.9, -850.0)],
         []),
        ("red", [(556, 0, -850.0), (556, 0, 559.2), (556, 548.9, 559.2), (556, 548.9, -850.0)],
         []),
        ("green", [(0, 0, -850.0), (0, 548.9, -850.0), (0, 548.9, 559.2), (0, 0, 559.2)], []),
        ("light", [p1 + shift, p2 + shift, p3 + shift, p4 + shift],
         transform(translate=(-50.0, 0.0, 50.0))),
    ]


def describe(config: dict, settings: dict, seed: int) -> dict:
    c = {k: color(v) for k, v in config["colors"].items()}

    def box(scale, degrees, at):
        return {"shape": "cube", "material": {"kind": "diffuse", "color": c["white"]},
                "transform": transform(scale=scale, rotate_y=2 * math.pi * (degrees / 360.0),
                                       translate=at)}

    meshes = []
    for col, points, steps in _polygons():
        o = {"shape": "mesh", "points": points, "vertices": _polygon(points), "normals": None,
             "transform": steps, "material": {"kind": "diffuse", "color": c[col]}}
        if col == "light":
            o["material"] = {"kind": "light", "color": c[col], "emittance": config["emittance"]}
            o["light"] = True  # added as geometry and as its light (scene.rs:57-75)
        meshes.append(o)
    objects = meshes[:-1] + [box((165.0, 330.0, 165.0), -253.0, (368.0, 165.0, 351.0)),
                             box((165.0, 165.0, 165.0), -197.0, (185.0, 82.5, 169.0)),
                             meshes[-1]]
    render = {k: settings[k] for k in ("integrator", "samples", "photons", "gather_size",
                                       "gather_size_volume", "watts")}
    return {"width": config["width"], "height": config["height"], "render": render,
            "max_bounces": config["max_bounces"], "media_max_depth": config["media_max_depth"],
            "exposure_value": config["exposure_value"], "camera": dict(config["camera"]),
            "objects": objects, "lights": [],
            "medium": dict(config["medium"]),
            "environment": {"kind": config["environment"]["kind"],
                            "color": color(config["environment"]["color"])},
            "filter_radius": config["filter"]["radius"]}


def build_renderer(desc: dict, seed: int, device: str):
    """The port's `Renderer` for ``desc``, as `torch_skybox_photons.renderer`
    builds it: the polygons (`rpt.polygon`) and the two cubes, the light
    added as ``(shape, material)`` (geometry and light), the sky as an
    `rpt.ColorEnvironment`, the fog, a `Filter.Box`; one sample, seeded."""
    import rpt_tpu_torch as rpt

    from perfbench.harness.port_scene import camera

    def material(m):
        col = rpt.hex_color(m["color"])
        if m["kind"] == "light":
            return rpt.Material.light(col, m["emittance"])
        return rpt.Material.diffuse(col)

    scene = rpt.Scene()
    for o in desc["objects"]:
        shape = rpt.cube() if o["shape"] == "cube" else rpt.polygon(o["points"])
        for op, arg in o["transform"]:
            shape = getattr(shape, op)(arg)
        mat = material(o["material"])
        scene.add((shape, mat) if o.get("light") else rpt.Object(shape).material(mat))
    sky = rpt.hex_color(desc["environment"]["color"])
    scene.add(rpt.ColorEnvironment(tuple(float(v) for v in sky.to_numpy())))
    med = desc["medium"]
    scene.add(rpt.Medium.homogeneous_isotropic(med["absorption"], med["scattering"]))
    return (rpt.Renderer(scene, camera(rpt, desc["camera"]), device=device)
            .width(desc["width"]).height(desc["height"])
            .filter(rpt.Filter.Box(desc["filter_radius"])).max_bounces(desc["max_bounces"])
            .media_max_depth(desc["media_max_depth"]).exposure_value(desc["exposure_value"])
            .num_samples(1).seed(seed))
