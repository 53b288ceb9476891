"""The dragon scene of `bench.py` (`examples/dragon.rs`: a specular
~871k-triangle mesh on a diffuse plane, an ambient light and two spherical
area lights; 512x512, 8 spp, 2 bounces) on the PyTorch port.

The Stanford dragon OBJ is not in the repository, so the mesh is the
procedural stand-in `bench.py` uses, ``displaced_blob(660, 661)``
(`bench.py:84-91`); ``build_scene(n_u, n_v)`` takes a smaller one for
tests.

    python examples/torch_dragon.py
"""

import math

import rpt_tpu_torch as rpt
from rpt_tpu_torch.meshes import displaced_blob

WIDTH = HEIGHT = 512
SPP = 8
MAX_BOUNCES = 2
MESH = (660, 661)  # displaced_blob grid: ~871k triangles


def build_scene(n_u: int = MESH[0], n_v: int = MESH[1]) -> rpt.Scene:
    """`bench.py:94-122` against the port."""
    dragon = displaced_blob(n_u, n_v)
    scene = rpt.Scene()
    scene.add(rpt.Object(dragon.scale((3.4, 3.4, 3.4)).rotate_y(math.pi / 2)).material(
        rpt.Material.specular(rpt.hex_color(0xB7CA79), 0.1)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))))
    scene.add(rpt.Light.Ambient((0.01, 0.01, 0.01)))
    scene.add(rpt.Light.Object(
        rpt.Object(rpt.sphere().scale((2.0, 2.0, 2.0)).translate((0.0, 20.0, 3.0))).material(
            rpt.Material.light((1.0, 1.0, 1.0), 160.0))))
    scene.add(rpt.Light.Object(
        rpt.Object(rpt.sphere().scale((0.05, 0.05, 0.05)).translate((-1.0, 0.71, 0.0))).material(
            rpt.Material.light(rpt.hex_color(0xFFAAAA), 400.0))))
    return scene


def camera() -> rpt.Camera:
    """`bench.py:175-177`."""
    return rpt.Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)


def renderer(device="cuda", size=WIDTH, spp=SPP, seed=0, scene=None) -> rpt.Renderer:
    return (rpt.Renderer(scene if scene is not None else build_scene(), camera(), device=device)
            .width(size).height(size).max_bounces(MAX_BOUNCES).num_samples(spp).seed(seed))


def main():
    """Render on the card; a preview (`preview_cut`) on the CPU with a
    4704-triangle mesh, the `Renderer` cutting its size and samples."""
    from _torch_assets import preview_cut, save

    mesh, device = preview_cut(MESH, (48, 49))
    r = renderer(device, scene=build_scene(*mesh))
    img = r.render()
    c = r.ray_counter
    print(f"{c.segments} ray segments in {c.seconds:.3f} s: "
          f"{c.segments / c.seconds / 1e6:.2f} Mrays/s on {device}")
    save(img, "output.png")


if __name__ == "__main__":
    main()
