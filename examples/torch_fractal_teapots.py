"""A recursive fractal of teapots on the PyTorch port
(`examples/fractal_teapots.py`, from `fractal_teapots.rs`): three levels
of `data/teapot.obj` copies (1, 6 and 30), each level one mesh in its own
colour, before a pink wall under ambient, directional and point lights,
800x600, 1 spp, no bounce:

    python examples/torch_fractal_teapots.py
"""

import math

import numpy as np
from _torch_assets import get_mesh, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT = 800, 600
COLORS = [0x264653, 0x2A9D8F, 0xE9C46A]  # 3 levels (teapots are heavy)


def gen(groups, p, rad, depth, last_dir, teapot):
    """`examples/fractal_teapots.py:14-27`: a teapot at ``p``, then five
    smaller ones around it (not back toward its parent)."""
    groups[depth].append(teapot.scale((0.5, 0.5, 0.5)).scale((rad, rad, rad)).translate(tuple(p)))
    if depth == len(groups) - 1:
        return
    disp = rad * 7.0 / 5.0
    dirs = [(disp, 0, 0), (-disp, 0, 0), (0, disp, 0), (0, -disp, 0), (0, 0, disp), (0, 0, -disp)]
    for i, d in enumerate(dirs):
        if last_dir is None or i != (last_dir ^ 1):
            gen(groups, p + np.asarray(d), rad * 2.0 / 5.0, depth + 1, i, teapot)


def build_scene() -> rpt.Scene:
    """`examples/fractal_teapots.py:30-53`."""
    teapot = get_mesh("teapot", fallback_tris=2000)
    groups = [[] for _ in COLORS]
    gen(groups, np.zeros(3), 1.0, 0, None, teapot)
    scene = rpt.Scene()
    for i, group in enumerate(groups):
        print(f"Level {i}: {len(group)} teapots")
        scene.add(rpt.Object(rpt.KdTree(group)).material(
            rpt.Material.specular(rpt.hex_color(COLORS[i]), 0.25)))
    scene.add(rpt.Object(rpt.plane((0.0, 0.0, 1.0), -6.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xFFCCCC))))
    scene.add(rpt.Light.Ambient((0.02, 0.02, 0.02)))
    d = np.array([0.0, -0.65, -1.0])
    scene.add(rpt.Light.Directional((0.6, 0.6, 0.6), tuple(d / np.linalg.norm(d))))
    scene.add(rpt.Light.Point((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def camera() -> rpt.Camera:
    dirv, upv = np.array([-0.285714, -0.5, -1.0]), np.array([0.0, 1.0, -0.5])
    return rpt.Camera(eye=(2.0, 3.5, 7.0), direction=tuple(dirv / np.linalg.norm(dirv)),
                      up=tuple(upv / np.linalg.norm(upv)), fov=math.pi / 6)


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(WIDTH).height(HEIGHT)
            .seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
