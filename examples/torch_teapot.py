"""A red metallic teapot on a plane on the PyTorch port
(`examples/teapot.py`, from `teapot.rs`): `data/teapot.obj` (2,256
triangles) at x0.5, under an ambient and a point light, 800x800, 1 spp, no
bounce:

    python examples/torch_teapot.py
"""

from _torch_assets import get_mesh, preview_cut, save

import rpt_tpu_torch as rpt

SIZE, SPP = 800, 1


def build_scene() -> rpt.Scene:
    """`examples/teapot.py:9-21`."""
    scene = rpt.Scene()
    scene.add(rpt.Object(
        get_mesh("teapot").scale((0.5, 0.5, 0.5)).translate((0.0, -1.0, 0.0))
    ).material(rpt.Material.metallic(rpt.hex_color(0xFF0000), 0.4)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))))
    scene.add(rpt.Light.Ambient((0.02, 0.02, 0.02)))
    scene.add(rpt.Light.Point((60.0, 60.0, 60.0), (0.0, 5.0, 5.0)))
    return scene


def renderer(device="cuda", size=SIZE, sample=SPP, seed=0) -> rpt.Renderer:
    """The example's renderer (its own parameters by default) on ``device``."""
    return (rpt.Renderer(build_scene(), rpt.Camera(), device=device)
            .width(size).height(size).num_samples(sample).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
