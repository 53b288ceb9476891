"""A default-material sphere on a grey plane under a spherical area light
(`examples/sphere.rs`), on the PyTorch port. ``renderer()`` defaults to the
settings of the golden image `tests/golden/sphere_64x36_16spp.npy`
(`tests/test_golden.py:17-33`); ``main`` renders the example's own 960x540,
100 spp:

    python examples/torch_sphere.py
"""

import math

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
    """Render on the card; a preview (`preview_cut`) on the CPU."""
    from _torch_assets import preview_cut, save

    _, device = preview_cut()
    img = renderer(device, 960, 540, 100, 0).render()
    save(img, "output.png")


if __name__ == "__main__":
    main()
