"""A recursive fractal of spheres on the PyTorch port
(`examples/fractal_spheres.py`, from `fractal_spheres.rs`): five levels
(1, 6, 30, 150 and 750 spheres), each level one group in its own colour,
before a pink wall under ambient, directional and point lights, 800x600,
1 spp, no bounce:

    python examples/torch_fractal_spheres.py
"""

import numpy as np
from _torch_assets import preview_cut, save
from torch_fractal_teapots import camera

import rpt_tpu_torch as rpt

WIDTH, HEIGHT = 800, 600
COLORS = [0x264653, 0x2A9D8F, 0xE9C46A, 0xF4A261, 0xE76F51]


def gen(spheres, p, rad, depth, last_dir):
    """`examples/fractal_spheres.py:14-25`."""
    spheres[depth].append(rpt.sphere().scale((rad, rad, rad)).translate(tuple(p)))
    if depth == len(spheres) - 1:
        return
    disp = rad * 7.0 / 5.0
    dirs = [(disp, 0, 0), (-disp, 0, 0), (0, disp, 0), (0, -disp, 0), (0, 0, disp), (0, 0, -disp)]
    for i, d in enumerate(dirs):
        if last_dir is None or i != (last_dir ^ 1):
            gen(spheres, p + np.asarray(d), rad * 2.0 / 5.0, depth + 1, i)


def build_scene() -> rpt.Scene:
    """`examples/fractal_spheres.py:28-49`."""
    spheres = [[] for _ in COLORS]
    gen(spheres, np.zeros(3), 1.0, 0, None)
    scene = rpt.Scene()
    for i, group in enumerate(spheres):
        print(f"Level {i}: {len(group)} spheres")
        scene.add(rpt.Object(rpt.KdTree(group)).material(
            rpt.Material.specular(rpt.hex_color(COLORS[i]), 0.25)))
    scene.add(rpt.Object(rpt.plane((0.0, 0.0, 1.0), -6.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xFFCCCC))))
    scene.add(rpt.Light.Ambient((0.02, 0.02, 0.02)))
    d = np.array([0.0, -0.65, -1.0])
    scene.add(rpt.Light.Directional((0.6, 0.6, 0.6), tuple(d / np.linalg.norm(d))))
    scene.add(rpt.Light.Point((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer (the camera of the teapot fractal) on
    ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(WIDTH).height(HEIGHT)
            .seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
