"""A default-material sphere on a grey plane under a spherical area light
(`examples/sphere.rs`), on the PyTorch port. ``renderer()`` defaults to the
settings of the golden image `tests/golden/sphere_64x36_16spp.npy`
(`tests/test_golden.py:17-33`); ``main`` renders the example's own 960x540,
100 spp:

    python examples/torch_sphere.py
"""

import math
import os

import rpt_tpu_torch as rpt


def build_scene() -> rpt.Scene:
    scene = rpt.Scene()
    scene.add(rpt.Object(rpt.sphere()))  # default grey material
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))))
    scene.add(rpt.Light.Object(
        rpt.Object(rpt.sphere().scale((2.0, 2.0, 2.0)).translate((0.0, 12.0, 0.0))).material(
            rpt.Material.light(rpt.hex_color(0xFFFFFF), 40.0))))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera.look_at((-2.5, 4.0, 6.5), (0.0, -0.25, 0.0), (0.0, 1.0, 0.0), math.pi / 4)


def renderer(device="cuda", width=64, height=36, spp=16, seed=42) -> rpt.Renderer:
    return (rpt.Renderer(build_scene(), camera(), device=device).width(width).height(height)
            .max_bounces(2).num_samples(spp).seed(seed))


def main():
    from _torch_assets import save

    width, height, spp = 960, 540, 100
    # on the card; as the JAX examples, RPT_TPU_PREVIEW=<s> makes a preview
    # on the CPU: the resolution divided by s, the samples capped at
    # RPT_TPU_PREVIEW_SAMPLES (4)
    preview = os.environ.get("RPT_TPU_PREVIEW")
    device = "cpu" if preview else "cuda"
    if preview:
        width, height = (max(8, v // max(1, int(preview))) for v in (width, height))
        spp = max(1, min(spp, int(os.environ.get("RPT_TPU_PREVIEW_SAMPLES", "4"))))
    img = renderer(device, width, height, spp, 0).render()
    save(img, "output.png")


if __name__ == "__main__":
    main()
