"""The dragon scene of `examples/dragon.rs:25-74` as plain data: a
specular mesh (the seeded ``displaced_blob`` stand-in) on a diffuse
plane, an ambient light and two sphere lights."""

from __future__ import annotations

from ._blob import displaced_blob
from ._common import color, transform


def describe(config: dict, settings: dict | None, seed: int) -> dict:
    mesh = config["mesh"]
    vertices, normals = displaced_blob(mesh["n_u"], mesh["n_v"], seed)
    s = mesh["scale"]
    dragon = {"shape": "mesh", "vertices": vertices, "normals": normals,
              "transform": [("scale", (s, s, s)), ("rotate_y", mesh["rotate_y"])],
              "material": {"kind": "specular", "color": color(config["material"]["color"]),
                           "roughness": config["material"]["roughness"]}}
    floor = {"shape": "plane", "normal": tuple(config["floor"]["normal"]),
             "value": config["floor"]["value"],
             "material": {"kind": "diffuse", "color": color(config["floor"]["color"])}}
    lights = [{"kind": "ambient", "color": tuple(config["ambient"])}]
    for light in config["sphere_lights"]:
        s = light["scale"]
        lights.append({"kind": "object", "shape": "sphere",
                       "transform": transform(scale=(s, s, s), translate=light["translate"]),
                       "material": {"kind": "light", "color": color(light["color"]),
                                    "emittance": light["emittance"]}})
    return {"width": config["width"], "height": config["height"],
            "max_bounces": config["max_bounces"], "media_max_depth": config["media_max_depth"],
            "exposure_value": config["exposure_value"], "camera": {"look_at": config["camera"]},
            "objects": [dragon, floor], "lights": lights, "medium": None}
