"""A lighthouse on a rock lit by a point light on the PyTorch port
(`examples/lighthouse.py`, from `lighthouse.rs`): `data/Rock.obj` and
`data/pyramid.obj` with cubes, path traced by ``render()`` at 512x512, 10
bounces, 100 spp (the example's photon count, watts, gather sizes and
medium coefficients name its output file; its scene has no medium):

    python examples/torch_lighthouse.py
"""

import os

from _torch_assets import get_mesh, preview_cut, save

import rpt_tpu_torch as rpt

absorb, scat = 0.0008, 0.0008
size, bounce, sample = 512, 10, 100
watts = 1_000_000.0
photons = 500_000
gather_size, gather_size_volume = 100, 30


def build_scene() -> rpt.Scene:
    """`examples/lighthouse.py:19-79`."""
    scene = rpt.Scene()
    white = rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
    red = rpt.Material.diffuse(rpt.hex_color(0xBC0000))
    yellow = rpt.Material.diffuse(rpt.hex_color(0xBCBC00))
    green = rpt.Material.diffuse(rpt.hex_color(0x00BC00))

    pyramid = get_mesh("pyramid", fallback_tris=200)

    sealevel, rock_height, base_size, light_size, top_size = 0.0, 100.0, 50.0, 10.0, 10.0
    lx, blocker = 100.0, 40.0
    rock_pos = (100.0, sealevel + rock_height / 2.0, 0.0)
    base_pos = (lx, sealevel + rock_height + base_size / 2.0, 0.0)
    light_pos = (lx, sealevel + rock_height + base_size + light_size / 2.0, 0.0)
    top_pos = (lx, sealevel + rock_height + base_size + light_size + top_size / 2.0, 0.0)

    rocks = get_mesh("Rock", fallback_tris=2000).scale((200.0, 100.0, 100.0)).translate(rock_pos)
    base2 = rpt.cube().scale((10.0, 50.0, 10.0)).translate(base_pos)
    light_front = rpt.cube().scale((blocker, blocker, 5.0)).translate(
        (light_pos[0], light_pos[1] + 5.0, light_pos[2] - 13.0))
    light_back = rpt.cube().scale((blocker, blocker, 5.0)).translate(
        (light_pos[0], light_pos[1] + 5.0, light_pos[2] + 13.0))
    top = pyramid.scale((blocker, 5.0, blocker)).translate(
        (top_pos[0], top_pos[1] + 13.0, top_pos[2]))
    left_boundary = rpt.cube().scale((10.0, 400.0, 10.0)).translate((250.0, 0.0, 0.0))
    right_boundary = rpt.cube().scale((10.0, -400.0, 10.0)).translate((250.0, 0.0, 0.0))

    scene.add(rpt.Object(rocks).material(white))
    scene.add(rpt.Object(base2).material(red))
    scene.add(rpt.Object(light_front).material(yellow))
    scene.add(rpt.Object(light_back).material(yellow))
    scene.add(rpt.Object(top).material(red))
    scene.add(rpt.Object(left_boundary).material(green))
    scene.add(rpt.Object(right_boundary).material(red))
    scene.add(rpt.Light.Point((1.0, 1.0, 1.0), (0.0, 200.0, 0.0)))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera(eye=(0.0, 200.0, -500.0), direction=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
                      fov=0.686)


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(size).height(size)
            .max_bounces(bounce).num_samples(sample).gather_size(gather_size).watts(watts)
            .gather_size_volume(gather_size_volume).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    os.makedirs("vpm/lighthouse", exist_ok=True)
    save(renderer(device).render(), f"vpm/lighthouse/e_{size}_{bounce}_{sample}_{photons}_"
                                    f"{watts}_{gather_size}_{gather_size_volume}_{absorb}_"
                                    f"{scat}.png")


if __name__ == "__main__":
    main()
