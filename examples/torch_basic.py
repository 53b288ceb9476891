"""Primitives under a point and an ambient light on the PyTorch port
(`examples/basic.py`, from `basic.rs`): a sphere, a box and two specular
balls on a specular plane, 800x600, 1 spp, no bounce:

    python examples/torch_basic.py
"""

import math

from _torch_assets import preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT = 800, 600


def add_primitives(scene: rpt.Scene, box_z: float = 4.0):
    """The objects and lights of `examples/basic.py:11-37`, the box's
    centre at depth ``box_z`` (`simple_video.py` moves it)."""
    scene.add(rpt.Object(rpt.sphere()))
    scene.add(rpt.Object(
        rpt.cube().rotate_y(math.pi / 6.0).scale((0.5, 0.3, 0.4)).translate((0.4, -0.8, box_z))
    ).material(rpt.Material.specular(rpt.hex_color(0xFF00FF), 0.5)))
    scene.add(rpt.Object(rpt.sphere().scale((0.5, 0.5, 0.5)).translate((1.5, -0.5, 1.0))).material(
        rpt.Material.specular(rpt.hex_color(0x0000FF), 0.1)))
    scene.add(rpt.Object(rpt.sphere().scale((0.5, 0.5, 0.5)).translate((-1.5, -0.5, 1.0)))
              .material(rpt.Material.specular(rpt.hex_color(0x00FF00), 0.1)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
        rpt.Material.specular(rpt.hex_color(0xAAAAAA), 0.5)))
    scene.add(rpt.Light.Ambient((0.01, 0.01, 0.01)))
    scene.add(rpt.Light.Point((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))


def build_scene() -> rpt.Scene:
    scene = rpt.Scene()
    add_primitives(scene)
    return scene


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), rpt.Camera(), device=device).width(WIDTH).height(HEIGHT)
            .seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
