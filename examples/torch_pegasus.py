"""An ice pegasus under a sky on the PyTorch port (`examples/pegasus.py`,
from `pegasus.rs`): `data/pegasus.obj` (100,138 triangles with smooth
vertex normals) at x1.4 in ice (`transparent(0xF8F8FF, 1.31, 0.2)`) over a
diffuse plane, 1200x1200, 8 bounces, 10 spp, lit by the HDRI
`birchwood_8k`. No `.hdr` file is in the repository, so, as with the JAX
example, the procedural sky of `_torch_assets.get_hdri` stands in:

    python examples/torch_pegasus.py
"""

from _torch_assets import get_hdri, get_mesh, preview_cut, save

import rpt_tpu_torch as rpt

WIDTH = HEIGHT = 1200
MAX_BOUNCES = 8
SPP = 10


def build_scene(mesh: rpt.Mesh | None = None) -> rpt.Scene:
    """`examples/pegasus.py:9-17`; ``mesh`` in place of the loaded pegasus
    (a decimated one for tests)."""
    scene = rpt.Scene()
    scene.add(get_hdri("birchwood_8k"))
    ice = rpt.Material.transparent(rpt.hex_color(0xF8F8FF), 1.31, 0.2)
    mesh = get_mesh("pegasus") if mesh is None else mesh
    scene.add(rpt.Object(mesh.scale((1.4, 1.4, 1.4))).material(ice))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xDDDDDD))))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera.look_at((-3.0, 2.0, 6.0), (0.0, 0.2, 0.0), (0.0, 1.0, 0.0), 0.6)


def renderer(device="cuda", size=WIDTH, sample=SPP, seed=0, scene=None) -> rpt.Renderer:
    """The example's renderer (its own parameters by default) on ``device``."""
    return (rpt.Renderer(scene if scene is not None else build_scene(), camera(), device=device)
            .width(size).height(size).max_bounces(MAX_BOUNCES).num_samples(sample).seed(seed))


def main():
    """Render at the example's parameters (a preview on the CPU:
    `preview_cut`) and save a PNG."""
    _, device = preview_cut()
    save(renderer(device).render(), "output.png")


if __name__ == "__main__":
    main()
