"""The foggy Cornell box, path traced, on the PyTorch port
(`examples/volumetric.py`, from `volumetric.rs`): two boxes in the
Cornell box under its ceiling light, in a homogeneous isotropic fog,
1024x1024, a box
filter, 4 bounces (the medium takes `trace_volumetric`, whose depth is
the renderer's default of 32), 1000 spp through `iterative_render`, a PNG
every 500 samples:

    python examples/torch_volumetric.py
"""

import math
import os
import time

from _torch_assets import preview_cut, save
from torch_volumetric_beamphoton_lampshade import camera

import rpt_tpu_torch as rpt

SIZE, MAX_BOUNCES, SPP, EVERY = 1024, 4, 1000, 500


def build_scene() -> rpt.Scene:
    """`examples/volumetric.py:13-59`."""
    scene = rpt.Scene()
    white = rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
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
    left_wall = rpt.polygon([(556, 0, 0), (556, 0, 559.2), (556, 548.9, 559.2), (556, 548.9, 0)])
    large_box = (rpt.cube().scale((165.0, 330.0, 165.0))
                 .rotate_y(2 * math.pi * (-253.0 / 360.0)).translate((368.0, 165.0, 351.0)))
    small_box = (rpt.cube().scale((165.0, 165.0, 165.0))
                 .rotate_y(2 * math.pi * (-197.0 / 360.0)).translate((185.0, 82.5, 169.0)))

    scene.add(rpt.Object(floor).material(white))
    scene.add(rpt.Object(ceiling).material(white))
    scene.add(rpt.Object(back_wall).material(white))
    scene.add(rpt.Object(left_wall).material(red))
    scene.add(rpt.Object(right_wall).material(green))
    scene.add(rpt.Object(large_box).material(white))
    scene.add(rpt.Object(small_box).material(white))
    scene.add((light_rect, light_mtl))
    scene.add(rpt.Medium.homogeneous_isotropic(0.0002, 0.002))  # foggy
    return scene


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(SIZE).height(SIZE)
            .filter(rpt.Filter.Box(1)).max_bounces(MAX_BOUNCES).num_samples(SPP).seed(seed))


def main():
    """Render progressively at the example's parameters (a preview on the
    CPU: `preview_cut`), saving a PNG every ``EVERY`` samples."""
    _, device = preview_cut()
    os.makedirs("volumetric_results", exist_ok=True)
    state = {"t": time.time()}

    def cb(iteration, buffer):
        millis = int((time.time() - state["t"]) * 1000)
        print(f"Finished iteration {iteration}, took {millis} ms, variance: {buffer.variance()}")
        save(buffer.image(), f"volumetric_results/output_{iteration - 1:03d}.png")
        state["t"] = time.time()

    renderer(device).iterative_render(EVERY, cb)


if __name__ == "__main__":
    main()
