"""Point-photon x point-query volumetric photon mapping of the lampshade
scene on the PyTorch port (`examples/volumetric_photonphoton_lampshade.rs`).

The scene and camera are `torch_volumetric_beamphoton_lampshade`'s, built
with `rpt_tpu_torch`, so this file runs where JAX is not installed:

    python examples/torch_volumetric_photonphoton_lampshade.py
"""

from torch_volumetric_beamphoton_lampshade import build_scene, camera, preview_cut, save

import rpt_tpu_torch as rpt

absorb, scat = 0.0008, 0.0008
size, bounce, sample = 128, 10, 100
watts = 10_000_000.0
photons = 1_000_000
gather_size, gather_size_volume = 100, 30


def renderer(device="cuda", size=size, bounce=bounce, sample=sample, seed=0) -> rpt.Renderer:
    """The example's renderer (its own parameters by default; the light's
    emittance is 120 and the watts are not scaled by the photon count), on
    ``device``."""
    scene = build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), 120.0))
    scene.add(rpt.Medium.homogeneous_isotropic(absorb, scat))
    return (
        rpt.Renderer(scene, camera(), device=device)
        .width(size)
        .height(size)
        .max_bounces(bounce)
        .num_samples(sample)
        .gather_size(gather_size)
        .watts(watts)
        .gather_size_volume(gather_size_volume)
        .seed(seed)
    )


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    img = renderer(device).photon_map_render(photons)
    save(img, f"lampshade/photonphoton/torch_{size}_{bounce}_{sample}_{photons}_{watts}_"
              f"{gather_size}_{gather_size_volume}_{absorb}_{scat}.png")


if __name__ == "__main__":
    main()
