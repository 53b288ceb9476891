"""OBJ + MTL multi-object loading on the PyTorch port (`examples/lego.py`,
from `lego.rs`): the objects of `data/lego.obj` with `data/lego.mtl`,
scaled by 0.002 under a spherical light, 960x540, 5 bounces, 20 spp.
Neither file is in the repository, so, as with the JAX example, an 8x8
plate of coloured bricks stands in (`examples/lego.py:23-36`):

    python examples/torch_lego.py
"""

import os
import sys

from _torch_assets import DATA, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, MAX_BOUNCES, SPP = 960, 540, 5, 20


def lego_objects():
    """The objects of `data/lego.obj` (`load_obj_with_mtl`), or the JAX
    example's brick plate; and whether they came from the files."""
    obj, mtl = os.path.join(DATA, "lego.obj"), os.path.join(DATA, "lego.mtl")
    if os.path.exists(obj) and os.path.exists(mtl):
        return rpt.load_obj_with_mtl(obj, mtl), True
    print("note: data/lego.obj(.mtl) not found; building a brick-plate stand-in", file=sys.stderr)
    colors = [0xC91A09, 0x0055BF, 0x237841, 0xF2CD37]
    objs = []
    for i in range(8):
        for j in range(8):
            objs.append(rpt.Object(
                rpt.cube().scale((90.0, 40.0, 90.0)).translate((i * 100.0, 20.0, j * 100.0))
            ).material(rpt.Material.diffuse(rpt.hex_color(colors[(i + j) % 4]))))
    return objs, False


def build_scene() -> rpt.Scene:
    """`examples/lego.py:40-56`."""
    objects, _ = lego_objects()
    scene = rpt.Scene()
    for obj in objects:
        shape = obj.shape.scale((0.002, 0.002, 0.002)).translate((-0.720, -0.243, -0.770))
        scene.add(rpt.Object(shape, obj._material))
    scene.add(rpt.Light.Object(
        rpt.Object(rpt.sphere().scale((6.0, 6.0, 6.0)).translate((0.0, 20.0, 30.0))).material(
            rpt.Material.light((1.0, 1.0, 1.0), 25.0))))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera.look_at((-1.5, 1.2, 2.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.6)


def renderer(device="cuda", seed=0) -> rpt.Renderer:
    """The example's renderer on ``device``."""
    return (rpt.Renderer(build_scene(), camera(), device=device).width(WIDTH).height(HEIGHT)
            .max_bounces(MAX_BOUNCES).num_samples(SPP).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
