"""The ice pegasus of `examples/pegasus.rs` (`examples/pegasus.py:9-25`)
as plain data, and the port's `Renderer` built from it.

`data/pegasus.obj` (100,138 triangles with smooth vertex normals) at
x1.4 in ice (``transparent(0xF8F8FF, 1.31, 0.2)``) over a diffuse plane,
under a sky. The OBJ is read twice: here by the benchmark's own numpy
parser, for the description that the plain reference reads, and in
``build_renderer`` by the port's loader (`rpt.load_obj`), as a user of
the port loads it. The sky is a frozen copy of the procedural map of
`examples/_torch_assets.get_hdri`, which stands in for the HDRI
``birchwood_8k`` that is not in the repository.

``config["mesh"]["triangles"]`` below the file's count keeps that many
triangles, rows chosen by ``linspace`` (the CPU tests' cut); at the
file's count the mesh is whole.
"""

from __future__ import annotations

import os

import numpy as np

from ._common import color

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _index(field: str, count: int) -> int:
    """A 1-based or negative OBJ index, 0-based against the ``count``
    entries read so far (io.rs:11-19)."""
    i = int(field)
    return i - 1 if i > 0 else count + i


def parse_obj(path: str):
    """``(vertices, normals)``, each (n, 3, 3) float64, of the ``v``,
    ``vn`` and ``f`` lines of an OBJ file: faces fan-triangulated
    (io.rs:164-201), a triangle whose corners lack a ``vn`` given its flat
    normal (shape/mesh.rs:27-37)."""
    points, normals, tri_v, tri_n = [], [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                points.append(tok[1:4])
            elif tok[0] == "vn":
                normals.append(tok[1:4])
            elif tok[0] == "f":
                corners = [(c.split("/") + ["", ""])[:3] for c in tok[1:]]
                v = [_index(c[0], len(points)) for c in corners]
                n = [_index(c[2], len(normals)) if c[2] else -1 for c in corners]
                for i in range(1, len(v) - 1):
                    tri_v.append((v[0], v[i], v[i + 1]))
                    corner_n = (n[0], n[i], n[i + 1])
                    tri_n.append((-1, -1, -1) if -1 in corner_n else corner_n)
    vertices = np.asarray(points, np.float64)[np.asarray(tri_v)]
    tri_n = np.asarray(tri_n)
    d = np.cross(vertices[:, 1] - vertices[:, 0], vertices[:, 2] - vertices[:, 0])
    length = np.linalg.norm(d, axis=-1, keepdims=True)
    out = np.repeat((d / np.where(length == 0.0, 1.0, length))[:, None, :], 3, axis=1)
    smooth = tri_n[:, 0] >= 0
    if smooth.any():
        out[smooth] = np.asarray(normals, np.float64)[tri_n[smooth]]
    return vertices, out


def sky(height: int = 256, width: int = 512) -> np.ndarray:
    """Frozen copy of `examples/_torch_assets.get_hdri`'s procedural map:
    a bright horizon band, a blue zenith and a small sun, (H, W, 3)."""
    y = np.linspace(0, np.pi, height)[:, None]
    x = np.linspace(0, 2 * np.pi, width)[None, :]
    out = np.zeros((height, width, 3))
    horizon = np.exp(-(((y - np.pi / 2) / 0.3) ** 2))
    out[..., 0] = 0.35 + 0.6 * horizon + 0.05 * np.cos(x)
    out[..., 1] = 0.45 + 0.5 * horizon
    out[..., 2] = 0.8 - 0.25 * np.cos(y)
    sun = 60.0 * np.exp(-(((y - 0.9) / 0.05) ** 2) - (((x - 2.0) / 0.05) ** 2))
    return out + sun[..., None] * np.array([1.0, 0.95, 0.9])


def _rows(total: int, keep: int):
    """The rows kept of ``total`` triangles: None for all of them."""
    if keep > total:
        raise ValueError(f"the mesh has {total} triangles, not {keep}")
    return None if keep == total else np.linspace(0, total - 1, keep).astype(np.int64)


def describe(config: dict, settings: dict | None, seed: int) -> dict:
    mesh = config["mesh"]
    path = os.path.join(CHECKOUT, mesh["file"])
    vertices, normals = parse_obj(path)
    rows = _rows(len(vertices), mesh["triangles"])
    if rows is not None:
        vertices, normals = vertices[rows], normals[rows]
    s = mesh["scale"]
    m = config["material"]
    pegasus = {"shape": "mesh", "file": path, "rows": rows, "vertices": vertices,
               "normals": normals, "transform": [("scale", (s, s, s))],
               "material": {"kind": "transparent", "color": color(m["color"]), "ior": m["ior"],
                            "roughness": m["roughness"]}}
    floor = {"shape": "plane", "normal": tuple(config["floor"]["normal"]),
             "value": config["floor"]["value"],
             "material": {"kind": "diffuse", "color": color(config["floor"]["color"])}}
    env = config["environment"]
    return {"width": config["width"], "height": config["height"],
            "max_bounces": config["max_bounces"], "media_max_depth": None,
            "exposure_value": config["exposure_value"], "camera": {"look_at": config["camera"]},
            "objects": [pegasus, floor], "lights": [], "medium": None,
            "environment": {"kind": "hdri", "map": sky(env["height"], env["width"])}}


def build_renderer(desc: dict, seed: int, device: str):
    """The port's `Renderer` for ``desc``, as `examples/torch_pegasus.py`
    builds it: the sky as an `rpt.Hdri`, the mesh loaded by `rpt.load_obj`
    and scaled, the ice and the plane; one sample a call, seeded."""
    import rpt_tpu_torch as rpt

    from perfbench.harness.port_scene import camera

    pegasus, floor = desc["objects"]
    scene = rpt.Scene()
    scene.add(rpt.Hdri(desc["environment"]["map"]))
    mesh = rpt.load_obj(pegasus["file"])
    if pegasus["rows"] is not None:
        mesh = rpt.Mesh(mesh.vertices[pegasus["rows"]], mesh.normals[pegasus["rows"]])
    for op, arg in pegasus["transform"]:
        mesh = getattr(mesh, op)(arg)
    m = pegasus["material"]
    scene.add(rpt.Object(mesh).material(rpt.Material.transparent(rpt.hex_color(m["color"]),
                                                                 m["ior"], m["roughness"])))
    scene.add(rpt.Object(rpt.plane(floor["normal"], floor["value"])).material(
        rpt.Material.diffuse(rpt.hex_color(floor["material"]["color"]))))
    return (rpt.Renderer(scene, camera(rpt, desc["camera"]), device=device)
            .width(desc["width"]).height(desc["height"]).max_bounces(desc["max_bounces"])
            .exposure_value(desc["exposure_value"]).num_samples(1).seed(seed))
