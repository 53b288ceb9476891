"""A depth-of-field demo in a Z-up scene on the PyTorch port
(`examples/spheres.py`, from `spheres.rs`): five specular spheres on a
plane under a spherical light, a thin-lens camera focused on the green
sphere, 800x600, 6 bounces, 1000 spp through `iterative_render`, a PNG
every 10 samples:

    python examples/torch_spheres.py
"""

import time

from _torch_assets import preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, MAX_BOUNCES, SPP, EVERY = 800, 600, 6, 1000, 10


def build_scene() -> rpt.Scene:
    """`examples/spheres.py:11-39`."""
    scene = rpt.Scene()
    red = rpt.Material.specular(rpt.hex_color(0xE78999), 0.1)
    yellow = rpt.Material.specular(rpt.hex_color(0xE7A94D), 0.1)
    green = rpt.Material.specular(rpt.hex_color(0xB3E7AA), 0.1)
    blue = rpt.Material.specular(rpt.hex_color(0x7CA3E7), 0.1)
    grey = rpt.Material.specular(rpt.hex_color(0xAAAAAA), 0.1)
    spheres = [((0.5, 4.0, 1.0), red), ((3.15, -0.7, 1.5), yellow), ((0.1, -2.0, 0.6), green),
               ((-1.7, -0.2, 1.1), blue), ((1.2, 0.4, 0.5), grey)]
    scene.add(rpt.Object(rpt.plane((0.0, 0.0, 1.0), 0.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xE7E7E7))))
    for pos, mtl in spheres:
        r = pos[2]
        scene.add(rpt.Object(rpt.sphere().scale((r, r, r)).translate(pos)).material(mtl))
    scene.add(rpt.Light.Object(
        rpt.Object(rpt.sphere().scale((2.0, 2.0, 2.0)).translate((1.2, -1.5, 8.0))).material(
            rpt.Material.light(rpt.hex_color(0xFFFFFF), 8.0))))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera.look_at(
        (0.7166, -9.2992, 2.8803), (0.8673, 0.2095, 0.9557), (0.0, 0.0, 1.0), 0.6911
    ).focus((0.1, -2.0, 0.6), 0.15)


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(WIDTH).height(HEIGHT)
            .max_bounces(MAX_BOUNCES).num_samples(SPP).seed(seed))


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
