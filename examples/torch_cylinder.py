"""An STL cylinder under point, directional and ambient lights on the
PyTorch port (`examples/cylinder.py`, from `cylinder.rs`):
`data/cylinder.stl` (a procedural 64-sided cylinder where it is absent,
as in the JAX example) normalised to a unit radius and height 2, turned by
45 degrees, on a plane, 512x512, 1 spp, no bounce:

    python examples/torch_cylinder.py
"""

import math
import os
import sys

import numpy as np
from _torch_assets import DATA, preview_cut, save

import rpt_tpu_torch as rpt

SIZE = 512


def cylinder_mesh() -> rpt.Mesh:
    """`data/cylinder.stl`, or the JAX example's stand-in of the same
    30x50-unit size (`examples/cylinder.py:17-37`)."""
    path = os.path.join(DATA, "cylinder.stl")
    if os.path.exists(path):
        return rpt.load_stl(path)
    print("note: data/cylinder.stl not found; using procedural cylinder", file=sys.stderr)
    n = 64
    a = np.linspace(0, 2 * np.pi, n + 1)
    tris = []
    for i in range(n):
        x0, z0 = 15 + 15 * np.cos(a[i]), 15 + 15 * np.sin(a[i])
        x1, z1 = 15 + 15 * np.cos(a[i + 1]), 15 + 15 * np.sin(a[i + 1])
        tris.append([[x0, z0, 0], [x1, z1, 0], [x0, z0, 50]])
        tris.append([[x1, z1, 0], [x1, z1, 50], [x0, z0, 50]])
        tris.append([[15, 15, 50], [x0, z0, 50], [x1, z1, 50]])
        tris.append([[15, 15, 0], [x1, z1, 0], [x0, z0, 0]])
    return rpt.Mesh(np.asarray(tris, np.float64))


def build_scene() -> rpt.Scene:
    """`examples/cylinder.py:40-60`."""
    scene = rpt.Scene()
    scene.add(rpt.Object(
        cylinder_mesh().translate((-15.0, -15.0, -25.0))
        .scale((1.0 / 15.0, 1.0 / 15.0, 1.0 / 25.0)).rotate_y(math.pi / 4.0)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))))
    scene.add(rpt.Light.Ambient((0.02, 0.02, 0.02)))
    scene.add(rpt.Light.Point((80.0, 80.0, 80.0), (0.0, 5.0, 5.0)))
    d = np.array([1.0, -1.0, 0.0])
    scene.add(rpt.Light.Directional((2.0, 2.0, 2.0), tuple(d / np.linalg.norm(d))))
    return scene


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), rpt.Camera(), device=device).width(SIZE).height(SIZE)
            .seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
