"""Frozen copy of `examples/torch_volumetric_beamphoton_lampshade.py::build_scene`, as plain data.

The lampshade scene that the four `examples/volumetric_*_lampshade.rs`
programs share (`:15-137`): a Cornell box of twelve
triangles, two boxes and four cube shades around the ceiling light (a
visible emitter and the only light), and a homogeneous isotropic medium,
with one program's settings (`settings`). A photon-mapping program's
integrator settings go under ``render``."""

from __future__ import annotations

import math

import numpy as np

from ._common import color, transform


def _polygon(points) -> np.ndarray:
    """Fan triangulation of a simple polygon (shape.rs:307-314)."""
    p = np.asarray(points, np.float64)
    return np.stack([np.stack([p[0], p[i], p[i + 1]]) for i in range(1, len(p) - 1)])


def describe(config: dict, settings: dict, seed: int) -> dict:
    c = {k: color(v) for k, v in config["colors"].items()}

    def diffuse(name):
        return {"kind": "diffuse", "color": c[name]}

    def mesh(points, name):
        return {"shape": "mesh", "vertices": _polygon(points), "normals": None,
                "transform": [], "material": diffuse(name)}

    floor = [(0, 0, 0), (0, 0, 559.2), (556, 0, 559.2), (556, 0, 0)]
    ceiling = [(0, 548.9, 0), (556, 548.9, 0), (556, 548.9, 559.2), (0, 548.9, 559.2)]
    light_rect = [(330.0, 548.8, 240.0), (330.0, 548.8, 319.0), (226.0, 548.8, 319.0),
                  (226.0, 548.8, 240.0)]
    back_wall = [(0, 0, 559.2), (0, 548.9, 559.2), (556, 548.9, 559.2), (556, 0, 559.2)]
    right_wall = [(0, 0, 0), (0, 548.9, 0), (0, 548.9, 559.2), (0, 0, 559.2)]
    left_wall = [(556, 0, 0), (556, 0, 559.2), (556, 548.9, 559.2), (556, 548.9, 0)]

    height, depth, width = 140.0, 105.0, 130.0
    center = (213.0 + 65.0, 548.0, 227.0 + 55.0)
    off = 10.0

    def shade(scale, offset):
        return {"shape": "cube", "material": diffuse("yellow"),
                "transform": transform(scale=scale, translate=[center[i] + offset[i]
                                                               for i in range(3)])}

    def box(scale, degrees, at):
        return {"shape": "cube", "material": diffuse("white"),
                "transform": transform(scale=scale, rotate_y=2 * math.pi * (degrees / 360.0),
                                       translate=at)}

    light = mesh(light_rect, "light")
    light["material"] = {"kind": "light", "color": c["light"], "emittance": settings["watts"]}
    light["light"] = True  # added as geometry and as its light (scene.rs:57-75)
    objects = [
        mesh(floor, "white"), mesh(ceiling, "white"), mesh(back_wall, "white"),
        mesh(left_wall, "red"), mesh(right_wall, "green"),
        box((165.0, 330.0, 165.0), -253.0, (368.0, 165.0, 351.0)),
        box((165.0, 165.0, 165.0), -197.0, (185.0, 82.5, 169.0)),
        shade((off, height, depth + off * 2), (width / 2, 0, 0)),
        shade((off, height, depth + off * 2), (-width / 2, 0, 0)),
        shade((width + off * 2, height, off), (0, 0, depth / 2)),
        shade((width + off * 2, height, off), (0, 0, -depth / 2)),
        light,
    ]
    render = {k: settings[k] for k in ("integrator", "samples", "photons", "gather_size",
                                       "gather_size_volume", "watts") if k in settings}
    return {"width": config["width"], "height": config["height"], "render": render,
            "max_bounces": config["max_bounces"], "media_max_depth": config["media_max_depth"],
            "exposure_value": config["exposure_value"], "camera": dict(config["camera"]),
            "objects": objects, "lights": [],
            "medium": {"kind": "homogeneous_isotropic", "absorption": settings["absorption"],
                       "scattering": settings["scattering"]}}
