"""The Rust crab with bubble eyes on the PyTorch port
(`examples/rustacean.py`, from `rustacean.rs`): `data/rustacean.obj` in
specular orange on a plane, six small glass and metal spheres, a
spherical light, 800x600, 3 bounces, 100 spp:

    python examples/torch_rustacean.py
"""

from _torch_assets import get_mesh, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, MAX_BOUNCES, SPP = 800, 600, 3, 100
CRAB_SCALE = (2.0, 2.4, 2.0)
# (clear glass, else metal; roughness; position before the crab's scale)
BUBBLES = [
    (True, 0.2, (-0.81, 1.02, 0.47)),
    (True, 0.3, (-0.86, 1.10, 0.36)),
    (True, 0.4, (-0.75, 1.12, 0.34)),
    (False, 0.2, (0.87, 1.03, 0.41)),
    (False, 0.3, (0.75, 1.09, 0.36)),
    (False, 0.4, (0.85, 1.15, 0.45)),
]


def build_scene() -> rpt.Scene:
    """`examples/rustacean.py:9-44`."""
    scene = rpt.Scene()
    scene.add(rpt.Object(
        get_mesh("rustacean").translate((0.0, 0.134649, 0.0)).scale(CRAB_SCALE)
    ).material(rpt.Material.specular(rpt.hex_color(0xF84C00), 0.2)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), 0.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xAAAA77))))
    for clear, roughness, pos in BUBBLES:
        p = tuple(c * s for c, s in zip(pos, CRAB_SCALE))
        mtl = (rpt.Material.clear(1.5, roughness) if clear
               else rpt.Material.metallic(rpt.hex_color(0xFFFFFF), roughness))
        scene.add(rpt.Object(rpt.sphere().scale((0.1, 0.1, 0.1)).translate(p)).material(mtl))
    scene.add(rpt.Light.Object(
        rpt.Object(rpt.sphere().scale((2.0, 2.0, 2.0)).translate((0.0, 20.0, 3.0))).material(
            rpt.Material.light((1.0, 1.0, 1.0), 160.0))))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera.look_at((-2.5, 4.0, 8.5), (0.0, 0.9, 0.0), (0.0, 1.0, 0.0), 0.5)


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(WIDTH).height(HEIGHT)
            .max_bounces(MAX_BOUNCES).num_samples(SPP).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
