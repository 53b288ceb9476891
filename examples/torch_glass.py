"""A metal ball and a glass ball under an HDRI on the PyTorch port
(`examples/glass.py`, from `glass.rs`): 1200x900, 5 bounces, 200 spp. No
`.hdr` file is in the repository, so, as with the JAX example, the
procedural sky of `_torch_assets.get_hdri` stands in for `ballroom_2k`:

    python examples/torch_glass.py
"""

from _torch_assets import get_hdri, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, MAX_BOUNCES, SPP = 1200, 900, 5, 200


def build_scene() -> rpt.Scene:
    """`examples/glass.py:9-21`."""
    scene = rpt.Scene()
    scene.add(get_hdri("ballroom_2k"))
    scene.add(rpt.Object(rpt.sphere().translate((1.1, 0.0, 0.0))).material(
        rpt.Material.metallic(rpt.hex_color(0xFFFFFF), 0.0001)))
    scene.add(rpt.Object(rpt.sphere().translate((-1.1, 0.0, 0.0))).material(
        rpt.Material.clear(1.5, 0.0001)))
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
