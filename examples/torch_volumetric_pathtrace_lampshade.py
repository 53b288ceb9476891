"""Volumetric path tracing of the lampshade scene on the PyTorch port
(`examples/volumetric_pathtrace_lampshade.rs`).

The scene and camera are `torch_volumetric_beamphoton_lampshade`'s, built
with `rpt_tpu_torch`, so this file runs where JAX is not installed:

    python examples/torch_volumetric_pathtrace_lampshade.py
"""

import time

from torch_volumetric_beamphoton_lampshade import build_scene, camera, preview_cut, save

import rpt_tpu_torch as rpt

absorb, scat = 0.00005, 0.003
size, bounce, sample = 128, 10, 1000
every_x = 100
watts = 150.0


def renderer(device="cuda", size=size, bounce=bounce, sample=sample, seed=0) -> rpt.Renderer:
    """The example's renderer (its own parameters by default; the media
    depth is the renderer's default of 32), on ``device``."""
    scene = build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), watts))
    scene.add(rpt.Medium.homogeneous_isotropic(absorb, scat))
    return (
        rpt.Renderer(scene, camera(), device=device)
        .width(size)
        .height(size)
        .max_bounces(bounce)
        .num_samples(sample)
        .seed(seed)
    )


def main():
    """Render progressively at the example's parameters (a preview on the
    CPU: `preview_cut`), saving a PNG every ``every_x`` samples."""
    _, device = preview_cut()
    state = {"t": time.time()}

    def cb(iteration, buffer):
        millis = int((time.time() - state["t"]) * 1000)
        print(f"Finished iteration {iteration}, took {millis} ms, variance: {buffer.variance()}")
        save(buffer.image(), f"lampshade/pathtrace/torch_output_{iteration - 1:03d}.png")
        state["t"] = time.time()

    renderer(device).iterative_render(every_x, cb)


if __name__ == "__main__":
    main()
