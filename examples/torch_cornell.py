"""The standard Cornell box with an area light (`examples/cornell.rs`), on
the PyTorch port. ``renderer()`` defaults to the settings of the golden
image `tests/golden/cornell_48x48_24spp.npy` (`tests/test_golden.py:
36-45`); ``main`` renders the example's own 512x512, 500 spp with a box
filter, printing the variance every 10 samples:

    python examples/torch_cornell.py
"""

import math
import os
import time

import rpt_tpu_torch as rpt


def build_scene() -> rpt.Scene:
    scene = rpt.Scene()
    white = rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
    red = rpt.Material.diffuse(rpt.hex_color(0xBC0000))
    green = rpt.Material.diffuse(rpt.hex_color(0x00BC00))
    light_mtl = rpt.Material.light(rpt.hex_color(0xFFFEFA), 100.0)  # 6500 K

    floor = rpt.polygon([(0.0, 0.0, 0.0), (0.0, 0.0, 559.2), (556.0, 0.0, 559.2),
                         (556.0, 0.0, 0.0)])
    ceiling = rpt.polygon([(0.0, 548.9, 0.0), (556.0, 548.9, 0.0), (556.0, 548.9, 559.2),
                           (0.0, 548.9, 559.2)])
    light_rect = rpt.polygon([(343.0, 548.8, 227.0), (343.0, 548.8, 332.0),
                              (213.0, 548.8, 332.0), (213.0, 548.8, 227.0)])
    back_wall = rpt.polygon([(0.0, 0.0, 559.2), (0.0, 548.9, 559.2), (556.0, 548.9, 559.2),
                             (556.0, 0.0, 559.2)])
    right_wall = rpt.polygon([(0.0, 0.0, 0.0), (0.0, 548.9, 0.0), (0.0, 548.9, 559.2),
                              (0.0, 0.0, 559.2)])
    left_wall = rpt.polygon([(556.0, 0.0, 0.0), (556.0, 0.0, 559.2), (556.0, 548.9, 559.2),
                             (556.0, 548.9, 0.0)])
    large_box = (rpt.cube().scale((165.0, 330.0, 165.0))
                 .rotate_y(2.0 * math.pi * (-253.0 / 360.0)).translate((368.0, 165.0, 351.0)))
    small_box = (rpt.sphere().scale((80.0, 80.0, 80.0))
                 .rotate_y(2.0 * math.pi * (-197.0 / 360.0)).translate((150.0, 82.5, 450.0)))

    scene.add(rpt.Object(floor).material(white))
    scene.add(rpt.Object(ceiling).material(white))
    scene.add(rpt.Object(back_wall).material(white))
    scene.add(rpt.Object(left_wall).material(red))
    scene.add(rpt.Object(right_wall).material(green))
    scene.add(rpt.Object(large_box).material(white))
    scene.add(rpt.Object(small_box).material(white))
    scene.add((light_rect, light_mtl))  # light and object at the same time
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera(eye=(278.0, 273.0, -800.0), direction=(0.0, 0.0, 1.0),
                      up=(0.0, 1.0, 0.0), fov=0.686)


def renderer(device="cuda", size=48, spp=24, seed=42) -> rpt.Renderer:
    return (rpt.Renderer(build_scene(), camera(), device=device).width(size).height(size)
            .max_bounces(2).num_samples(spp).seed(seed))


def main():
    """Render on the card; a preview (`preview_cut`) on the CPU."""
    from _torch_assets import preview_cut, save

    _, device = preview_cut()
    os.makedirs("results", exist_ok=True)
    state = {"time": time.time()}

    def callback(iteration, buffer):
        millis = int((time.time() - state["time"]) * 1000)
        print(f"Finished iteration {iteration}, took {millis} ms, variance: {buffer.variance()}")
        save(buffer.image(), f"results/output_{iteration - 1:03d}.png")
        state["time"] = time.time()

    renderer(device, 512, 500, 0).filter(rpt.Filter.Box(1)).iterative_render(10, callback)


if __name__ == "__main__":
    main()
