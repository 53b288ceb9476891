"""Point-photon x beam-query volumetric photon mapping of the lampshade
scene on the PyTorch port (`examples/volumetric_beamphoton_lampshade.rs`).

The scene and camera are those of `examples/_lampshade.py`, built with
`rpt_tpu_torch`, so this file runs where JAX is not installed:

    python examples/torch_volumetric_beamphoton_lampshade.py
"""

from _torch_assets import preview_cut, save  # noqa: F401 (the lampshade drivers import them here)

import rpt_tpu_torch as rpt

absorb, scat = 0.0001, 0.001
size, bounce, sample = 128, 10, 50
watts = 200_000.0 / (130.0 * 105.0)
photons = 1_000_000
gather_size, gather_size_volume = 20, 3


def camera() -> rpt.Camera:
    return rpt.Camera(
        eye=(278.0, 273.0, -800.0), direction=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0), fov=0.686
    )


def build_scene(light_mtl: rpt.Material) -> rpt.Scene:
    """Cornell box with four cube shades boxing in the ceiling light
    (reference `examples/volumetric_*_lampshade.rs:15-137`)."""
    scene = rpt.Scene()
    white = rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
    red = rpt.Material.diffuse(rpt.hex_color(0xBC0000))
    yellow = rpt.Material.diffuse(rpt.hex_color(0xBCBC00))
    green = rpt.Material.diffuse(rpt.hex_color(0x00BC00))

    floor = rpt.polygon([(0, 0, 0), (0, 0, 559.2), (556, 0, 559.2), (556, 0, 0)])
    ceiling = rpt.polygon([(0, 548.9, 0), (556, 548.9, 0), (556, 548.9, 559.2), (0, 548.9, 559.2)])
    # width 130, depth 105
    light_rect = rpt.polygon(
        [(330.0, 548.8, 240.0), (330.0, 548.8, 319.0), (226.0, 548.8, 319.0), (226.0, 548.8, 240.0)]
    )
    back_wall = rpt.polygon(
        [(0, 0, 559.2), (0, 548.9, 559.2), (556, 548.9, 559.2), (556, 0, 559.2)]
    )
    right_wall = rpt.polygon([(0, 0, 0), (0, 548.9, 0), (0, 548.9, 559.2), (0, 0, 559.2)])
    left_wall = rpt.polygon(
        [(556, 0, 0), (556, 0, 559.2), (556, 548.9, 559.2), (556, 548.9, 0)]
    )

    height, depth, width = 140.0, 105.0, 130.0
    center = (213.0 + 65.0, 548.0, 227.0 + 55.0)
    off = 10.0

    def shade(scale, offset):
        return rpt.cube().scale(scale).translate(
            (center[0] + offset[0], center[1] + offset[1], center[2] + offset[2])
        )

    front_shade = shade((width + off * 2, height, off), (0, 0, depth / 2))
    left_shade = shade((off, height, depth + off * 2), (-width / 2, 0, 0))
    back_shade = shade((width + off * 2, height, off), (0, 0, -depth / 2))
    right_shade = shade((off, height, depth + off * 2), (width / 2, 0, 0))

    large_box = (
        rpt.cube()
        .scale((165.0, 330.0, 165.0))
        .rotate_y(2 * 3.141592653589793 * (-253.0 / 360.0))
        .translate((368.0, 165.0, 351.0))
    )
    small_box = (
        rpt.cube()
        .scale((165.0, 165.0, 165.0))
        .rotate_y(2 * 3.141592653589793 * (-197.0 / 360.0))
        .translate((185.0, 82.5, 169.0))
    )

    scene.add(rpt.Object(floor).material(white))
    scene.add(rpt.Object(ceiling).material(white))
    scene.add(rpt.Object(back_wall).material(white))
    scene.add(rpt.Object(left_wall).material(red))
    scene.add(rpt.Object(right_wall).material(green))
    scene.add(rpt.Object(large_box).material(white))
    scene.add(rpt.Object(small_box).material(white))
    scene.add(rpt.Object(right_shade).material(yellow))
    scene.add(rpt.Object(left_shade).material(yellow))
    scene.add(rpt.Object(front_shade).material(yellow))
    scene.add(rpt.Object(back_shade).material(yellow))
    scene.add((light_rect, light_mtl))
    return scene


def renderer(device="cuda", size=size, bounce=bounce, sample=sample, photons=photons,
             seed=0) -> rpt.Renderer:
    """The example's renderer (its own parameters by default), with the
    medium added and watts scaled by the photon count, on ``device``."""
    scene = build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), watts))
    scene.add(rpt.Medium.homogeneous_isotropic(absorb, scat))
    return (
        rpt.Renderer(scene, camera(), device=device)
        .width(size)
        .height(size)
        .max_bounces(bounce)
        .num_samples(sample)
        .gather_size(gather_size)
        .watts(watts * photons)
        .gather_size_volume(gather_size_volume)
        .seed(seed)
    )


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    img = renderer(device).photon_point_query_beam_render(photons)
    save(img, f"lampshade/beamphoton/torch_{size}_{bounce}_{sample}_{photons}_{watts}_"
              f"{gather_size}_{gather_size_volume}_{absorb}_{scat}.png")


if __name__ == "__main__":
    main()
