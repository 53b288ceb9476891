"""The Cornell box with a mirror sphere on the PyTorch port
(`examples/cornell_mirror.py`, from `cornell_mirror.rs`): 512x512, a box
filter, 5 bounces, 500 spp through `iterative_render`, a PNG every 10
samples; the ceiling light is added as a light and again as an object
(`cornell_mirror.rs:119-120`):

    python examples/torch_cornell_mirror.py
"""

import math
import time

from _torch_assets import preview_cut, save
from torch_volumetric_beamphoton_lampshade import camera

import rpt_tpu_torch as rpt

SIZE, MAX_BOUNCES, SPP, EVERY = 512, 5, 500, 10


def build_scene() -> rpt.Scene:
    """`examples/cornell_mirror.py:16-59`."""
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
    mirror_sphere = rpt.sphere().scale((100.0, 100.0, 100.0)).translate((400.0, 82.0, 300.0))
    small_box = (rpt.cube().scale((165.0, 165.0, 165.0))
                 .rotate_y(2 * math.pi * (-197.0 / 360.0)).translate((180.0, 82.5, 160.0)))

    scene.add(rpt.Object(floor).material(white))
    scene.add(rpt.Object(ceiling).material(white))
    scene.add(rpt.Object(back_wall).material(white))
    scene.add(rpt.Object(left_wall).material(red))
    scene.add(rpt.Object(right_wall).material(green))
    scene.add(rpt.Object(mirror_sphere).material(rpt.Material.mirror()))
    scene.add(rpt.Object(small_box).material(white))
    scene.add(rpt.Light.Object(rpt.Object(light_rect).material(light_mtl)))
    scene.add(rpt.Object(light_rect).material(light_mtl))
    return scene


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer (the Cornell camera of the lampshade
    drivers) on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(SIZE).height(SIZE)
            .filter(rpt.Filter.Box(1)).max_bounces(MAX_BOUNCES).num_samples(SPP).seed(seed))


def main():
    """Render progressively at the example's parameters (a preview on the
    CPU: `preview_cut`), saving a PNG every ``EVERY`` samples."""
    _, device = preview_cut()
    state = {"t": time.time()}

    def cb(iteration, buffer):
        millis = int((time.time() - state["t"]) * 1000)
        print(f"Finished iteration {iteration}, took {millis} ms, variance: {buffer.variance()}")
        save(buffer.image(), f"output_{iteration - 1:03d}.png")
        state["t"] = time.time()

    renderer(device).iterative_render(EVERY, cb)


if __name__ == "__main__":
    main()
