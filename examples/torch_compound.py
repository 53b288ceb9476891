"""The compound of five cubes on the PyTorch port (`examples/compound.py`,
from `compound.rs`): five specular cubes turned by the magic angle about
(1, 1, 1) and mirrored, on a white plane under three spherical lamps,
1024x1024, 5 bounces, 50 spp:

    python examples/torch_compound.py
"""

import math

from _torch_assets import preview_cut, save

import rpt_tpu_torch as rpt

SIZE, MAX_BOUNCES, SPP = 1024, 5, 50


def lamp(x, y, z, r, e):
    return rpt.Light.Object(rpt.Object(rpt.sphere().scale((r, r, r)).translate((x, y, z)))
                            .material(rpt.Material.light((1.0, 1.0, 1.0), e)))


def build_scene() -> rpt.Scene:
    """`examples/compound.py:18-43`."""
    scene = rpt.Scene()
    magic_angle = math.acos((3.0 * math.sqrt(5.0) - 1.0) / 8.0)
    c_central = rpt.cube()
    c_green = c_central.rotate(-magic_angle, (1.0, 1.0, 1.0))
    c_red = c_green.scale((-1.0, 1.0, 1.0))
    c_blue = c_green.scale((1.0, -1.0, 1.0))
    c_orange = c_red.scale((1.0, -1.0, 1.0))
    for shape, color in ((c_central, 0xC144EB), (c_green, 0x45E542), (c_red, 0xF55142),
                         (c_blue, 0x4275F5), (c_orange, 0xF5BF42)):
        scene.add(rpt.Object(shape).material(rpt.Material.specular(rpt.hex_color(color), 0.4)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -0.80902)).material(
        rpt.Material.diffuse(rpt.hex_color(0xFFFFFF))))
    scene.add(lamp(-2.0, 3.5, 0.5, 0.5, 60.0))
    scene.add(lamp(0.0, 0.5, 5.0, 1.0, 2.0))
    scene.add(lamp(2.0, 1.0, -5.0, 0.6, 10.0))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera.look_at((-0.9, 1.2, 2.4), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 4)


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(SIZE).height(SIZE)
            .max_bounces(MAX_BOUNCES).num_samples(SPP).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
