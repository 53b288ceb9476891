"""A glass mesh on a wooden floor under an HDRI and a spherical light on
the PyTorch port (`examples/wine_glass.py`, from `wine_glass.rs`):
`data/wine_glass.obj` in clear glass, 1920x1080, 6 bounces, 1000 spp
through `iterative_render`, a PNG every 10 samples; the procedural sky
of `_torch_assets.get_hdri` stands in for `ballroom_8k` (no `.hdr` file
is in the repository), as with the JAX example:

    python examples/torch_wine_glass.py
"""

import time

from _torch_assets import get_hdri, get_mesh, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, MAX_BOUNCES, SPP, EVERY = 1920, 1080, 6, 1000, 10


def build_scene() -> rpt.Scene:
    """`examples/wine_glass.py:11-28`."""
    scene = rpt.Scene()
    scene.add(get_hdri("ballroom_8k"))
    scene.add(rpt.Object(get_mesh("wine_glass")).material(rpt.Material.clear(1.5, 0.0001)))
    scene.add(rpt.Object(rpt.polygon(
        [(-5.0, 0.0, -5.0), (-5.0, 0.0, 5.0), (5.0, 0.0, 5.0), (5.0, 0.0, -5.0)]
    )).material(rpt.Material.diffuse(rpt.hex_color(0x6F5D48))))
    scene.add(rpt.Light.Object(rpt.Object(
        rpt.sphere().scale((3.0, 3.0, 3.0)).translate((11.15, 13.739, -4.9325))
    ).material(rpt.Material.light(rpt.hex_color(0xFFFFFF), 200.0))))
    return scene


def camera() -> rpt.Camera:
    eye = (5.530, 4.375, 5.384)
    return rpt.Camera.look_at(eye, (eye[0] - 0.6962, eye[1] - 0.3754, eye[2] - 0.6119),
                              (0.0, 1.0, 0.0), 0.6911)


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
