"""Photon mapping of the open foggy Cornell scene under a sky on the
PyTorch port (`examples/skybox_photons.py`, from `skybox_photons.rs`):
256x256, a box filter, 10 bounces, 100 spp, 10M photons, and the gather
sizes left at `Renderer`'s defaults (50 / 50). The scene has a medium, so
each wavefront of the camera pass gathers twice, over the surface photons
and over the volume photons, both at k = 50:

    python examples/torch_skybox_photons.py
"""

import os

from _torch_assets import preview_cut, save
from _torch_skybox import build_scene, camera

import rpt_tpu_torch as rpt

SIZE, MAX_BOUNCES, SPP = 256, 10, 100
PHOTONS = 10_000_000


def renderer(device="cuda", size=SIZE, sample=SPP, seed=0) -> rpt.Renderer:
    """The example's renderer (its own parameters by default; gather sizes
    and watts are `Renderer`'s defaults), on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(size).height(size)
            .filter(rpt.Filter.Box(1)).max_bounces(MAX_BOUNCES).num_samples(sample).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    os.makedirs("skybox", exist_ok=True)
    save(renderer(device).photon_map_render(PHOTONS), "skybox/photon.png")


if __name__ == "__main__":
    main()
