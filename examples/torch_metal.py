"""Two metal teapots under an HDRI on the PyTorch port (`examples/metal.py`,
from `metal.rs`): `data/teapot.obj` twice at x0.5, one rough and one a
mirror, 1200x900, 5 bounces, 20 spp; the procedural sky of
`_torch_assets.get_hdri` stands in for `ballroom_2k` (no `.hdr` file is in
the repository), as with the JAX example:

    python examples/torch_metal.py
"""

from _torch_assets import get_hdri, get_mesh, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, MAX_BOUNCES, SPP = 1200, 900, 5, 20


def build_scene() -> rpt.Scene:
    """`examples/metal.py:9-23`."""
    teapot = get_mesh("teapot")
    scene = rpt.Scene()
    scene.add(get_hdri("ballroom_2k"))
    scene.add(rpt.Object(teapot.scale((0.5, 0.5, 0.5)).translate((0.0, -1.7, 0.0))).material(
        rpt.Material.metallic(rpt.hex_color(0xFFFFFF), 0.1)))
    scene.add(rpt.Object(teapot.scale((0.5, 0.5, 0.5)).translate((0.0, 0.2, 0.0))).material(
        rpt.Material.metallic(rpt.hex_color(0xFFFFFF), 0.0001)))
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
