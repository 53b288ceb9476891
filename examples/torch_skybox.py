"""The open foggy Cornell box under a sky, path traced, on the PyTorch
port (`examples/skybox.py`, from `skybox.rs`): 512x512, 4 bounces (the
medium takes `trace_volumetric`, whose depth is the renderer's default
of 32), 5000 spp through `iterative_render`, a PNG every 1000 samples:

    python examples/torch_skybox.py
"""

import os
import time

from _torch_assets import preview_cut, save
from _torch_skybox import build_scene, camera

import rpt_tpu_torch as rpt

SIZE, MAX_BOUNCES, SPP, EVERY = 512, 4, 5000, 1000


def renderer(device="cuda", size=SIZE, sample=SPP, seed=0) -> rpt.Renderer:
    """The example's renderer (its own parameters by default) on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(size).height(size)
            .max_bounces(MAX_BOUNCES).num_samples(sample).seed(seed))


def main():
    """Render progressively at the example's parameters (a preview on the
    CPU: `preview_cut`), saving a PNG every ``EVERY`` samples."""
    _, device = preview_cut()
    os.makedirs("skybox", exist_ok=True)
    state = {"t": time.time()}

    def cb(iteration, buffer):
        millis = int((time.time() - state["t"]) * 1000)
        print(f"Finished iteration {iteration}, took {millis} ms, variance: {buffer.variance()}")
        save(buffer.image(), f"skybox/output_{iteration - 1:03d}.png")
        state["t"] = time.time()

    renderer(device).iterative_render(EVERY, cb)


if __name__ == "__main__":
    main()
