"""A metallic monomial surface among the primitives of `basic.py`, under
an HDRI, on the PyTorch port (`examples/monomial_glass.py`, from
`monomial_glass.rs:28-86`): 800x600, 1 bounce, 100 spp; the procedural
sky of `_torch_assets.get_hdri` stands in for `ballroom_2k` (no `.hdr`
file is in the repository), as with the JAX example:

    python examples/torch_monomial_glass.py
"""

import math

from _torch_assets import get_hdri, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, MAX_BOUNCES, SPP = 800, 600, 1, 100


def build_scene() -> rpt.Scene:
    """`examples/monomial_glass.py:11-46`."""
    scene = rpt.Scene()
    scene.add(get_hdri("ballroom_2k"))
    scene.add(rpt.Object(rpt.monomial_surface(2.0, 4.0).translate((0.0, -1.0, 0.0))).material(
        rpt.Material.metallic(rpt.hex_color(0xFFFFFF), 0.0001)))
    scene.add(rpt.Object(
        rpt.cube().rotate_y(math.pi / 6.0).scale((0.5, 0.3, 0.4)).translate((0.4, -0.8, 4.0))
    ).material(rpt.Material.specular(rpt.hex_color(0xFF00FF), 0.5)))
    scene.add(rpt.Object(rpt.sphere().scale((0.5, 0.5, 0.5)).translate((1.5, -0.5, 1.0))).material(
        rpt.Material.specular(rpt.hex_color(0x0000FF), 0.1)))
    scene.add(rpt.Object(rpt.sphere().scale((0.5, 0.5, 0.5)).translate((-1.5, -0.5, 1.0)))
              .material(rpt.Material.specular(rpt.hex_color(0x00FF00), 0.1)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
        rpt.Material.specular(rpt.hex_color(0xAAAAAA), 0.5)))
    scene.add(rpt.Light.Ambient((0.01, 0.01, 0.01)))
    scene.add(rpt.Light.Point((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), rpt.Camera(), device=device).width(WIDTH).height(HEIGHT)
            .max_bounces(MAX_BOUNCES).num_samples(SPP).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
