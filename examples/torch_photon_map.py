"""Surface photon mapping of a Cornell variant with a transmissive sphere
and a rotated box on the PyTorch port (`examples/photon_map.py`, from
`photon_map.rs`): 512x512, a box filter, 5 bounces, 10 spp, 10M photons,
and the gather sizes left at `Renderer`'s defaults (50 / 50). The scene has
no medium, so each wavefront of the camera pass gathers once, over the
surface photons, at k = 50. It runs where JAX is not installed:

    python examples/torch_photon_map.py
"""

import math

from torch_volumetric_beamphoton_lampshade import camera, preview_cut, save

import rpt_tpu_torch as rpt

size, bounce, sample = 512, 5, 10
photons = 10_000_000


def build_scene() -> rpt.Scene:
    """`examples/photon_map.py:12-48`."""
    scene = rpt.Scene()
    white = rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
    transmissive = rpt.Material.transmissive(1.5)
    red = rpt.Material.diffuse(rpt.hex_color(0xBC0000))
    green = rpt.Material.diffuse(rpt.hex_color(0x00BC00))
    light_mtl = rpt.Material.light(rpt.hex_color(0xFFFEFA), 100.0)

    floor = rpt.polygon([(0, 0, 0), (0, 0, 559.2), (556, 0, 559.2), (556, 0, 0)])
    ceiling = rpt.polygon([(0, 548.9, 0), (556, 548.9, 0), (556, 548.9, 559.2), (0, 548.9, 559.2)])
    light_rect = rpt.polygon(
        [(343.0, 548.8, 227.0), (343.0, 548.8, 332.0), (213.0, 548.8, 332.0), (213.0, 548.8, 227.0)]
    )
    back_wall = rpt.polygon(
        [(0, 0, 559.2), (0, 548.9, 559.2), (556, 548.9, 559.2), (556, 0, 559.2)]
    )
    right_wall = rpt.polygon([(0, 0, 0), (0, 548.9, 0), (0, 548.9, 559.2), (0, 0, 559.2)])
    left_wall = rpt.polygon(
        [(556, 0, 0), (556, 0, 559.2), (556, 548.9, 559.2), (556, 548.9, 0)]
    )
    glass_sphere = rpt.sphere().scale((100.0, 100.0, 100.0)).translate((185.0, 82.5, 169.0))
    small_box = (
        rpt.cube()
        .scale((165.0, 165.0, 165.0))
        .rotate_y(2 * math.pi * (-197.0 / 360.0))
        .translate((400.0, 82.0, 300.0))
    )

    scene.add(rpt.Object(floor).material(white))
    scene.add(rpt.Object(ceiling).material(white))
    scene.add(rpt.Object(back_wall).material(white))
    scene.add(rpt.Object(left_wall).material(red))
    scene.add(rpt.Object(right_wall).material(green))
    scene.add(rpt.Object(glass_sphere).material(transmissive))
    scene.add(rpt.Object(small_box).material(white))
    scene.add(rpt.Light.Object(rpt.Object(light_rect).material(light_mtl)))
    return scene


def renderer(device="cuda", size=size, sample=sample, seed=0) -> rpt.Renderer:
    """The example's renderer (its own parameters by default; gather sizes
    and watts are `Renderer`'s defaults), on ``device``."""
    return (
        rpt.Renderer(build_scene(), camera(), device=device)
        .width(size)
        .height(size)
        .filter(rpt.Filter.Box(1))
        .max_bounces(bounce)
        .num_samples(sample)
        .seed(seed)
    )


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    img = renderer(device).photon_map_render(photons)
    save(img, "output7.png")


if __name__ == "__main__":
    main()
