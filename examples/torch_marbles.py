"""RK4 marble physics in a glass on the PyTorch port (`examples/marbles.py`,
from `marbles.rs`): 25 marbles of radius 0.15 under `MarblesSystem`, a
clear monomial-surface glass, a spherical light and the HDRI
`ballroom_8k` (the procedural sky stands in: no `.hdr` file is in the
repository), 800x600, 9 bounces, 2000 spp, a frame every 1/16 s of RK4
steps of 1e-4 s; the frames are muxed with ffmpeg where it is installed.
RPT_TPU_FRAMES caps the frame count (180):

    python examples/torch_marbles.py
"""

import math
import os
import subprocess

import numpy as np
from _torch_assets import get_hdri, preview_cut, save

import rpt_tpu_torch as rpt
from rpt_tpu_torch.ode import MarblesSystem, ParticleState, monomial_closest_point_precise

N, R = 25, 0.15
FRAMES = 180
WIDTH, HEIGHT, MAX_BOUNCES, SPP = 800, 600, 9, 2000
FRAME_TIME, STEP = 1.0 / 16.0, 1.0 / 10000.0
COLORS = [0x264653, 0x2A9D8F, 0xE9C46A, 0xF4A261, 0xE76F51]


def initial_state(device="cuda") -> ParticleState:
    """A 5x5 grid of marbles dropped from heights in [4, 6) (seed 123)."""
    rng = np.random.default_rng(123)
    pos = np.array(
        [[(i // 5) / 5.0 - 0.375, rng.uniform(4.0, 6.0), (i % 5) / 5.0 - 0.375] for i in range(N)]
    )
    return ParticleState.of(pos, np.zeros((N, 3)), device)


def marble_positions(state: ParticleState) -> np.ndarray:
    """The marbles' centres as drawn (`examples/marbles.py:54-61`): pushed
    out of the glass to 1.05 R and kept on the table."""
    cur = state.pos.to_numpy()
    closest = monomial_closest_point_precise(2.0, state.pos).to_numpy()
    vec = cur - closest
    length = np.linalg.norm(vec, axis=1, keepdims=True)
    out = np.where(length < R * 1.05, closest + vec / np.maximum(length, 1e-12) * R * 1.05, cur)
    out[:, 1] = np.maximum(out[:, 1], R - 0.06)
    return out


def build_scene(positions: np.ndarray, hdri: rpt.Hdri) -> rpt.Scene:
    """`examples/marbles.py:36-75`: the sky, the spherical light, the glass,
    the marbles at ``positions`` and the table."""
    scene = rpt.Scene()
    scene.add(hdri)
    scene.add(rpt.Light.Object(
        rpt.Object(rpt.sphere().scale((1.5, 1.5, 1.5)).translate((0.0, 5.0, 0.0))).material(
            rpt.Material.light(rpt.hex_color(0xFFFFFF), 15.0))))
    # the reference loads examples/monomial.obj; the analytic surface is
    # the same shape (marbles.rs:94 uses monomial_surface(2., 4.))
    scene.add(rpt.Object(rpt.monomial_surface(2.0)).material(rpt.Material.clear(1.5, 0.0001)))
    for i, p in enumerate(positions):
        scene.add(rpt.Object(rpt.sphere().scale((R, R, R)).translate(tuple(p))).material(
            rpt.Material.specular(rpt.hex_color(COLORS[i % len(COLORS)]), 0.1)))
    scene.add(rpt.Object(rpt.polygon(
        [(20.0, -0.06, 20.0), (20.0, -0.06, -20.0), (-20.0, -0.06, -20.0), (-20.0, -0.06, 20.0)]
    )).material(rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))))
    return scene


def camera() -> rpt.Camera:
    return rpt.Camera.look_at(
        (0.0, 1.0, 6.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), math.pi / 4
    ).focus((0.0, 1.0, 0.0), 0.02)


def renderer(device="cuda", positions=None, hdri=None, width=WIDTH, height=HEIGHT,
             sample=SPP, seed=0) -> rpt.Renderer:
    """One frame's renderer (the example's parameters by default; the
    marbles where they start) on ``device``."""
    if positions is None:
        positions = marble_positions(initial_state(device))
    scene = build_scene(positions, hdri if hdri is not None else get_hdri("ballroom_8k"))
    return (rpt.Renderer(scene, camera(), device=device).width(width).height(height)
            .max_bounces(MAX_BOUNCES).num_samples(sample).seed(seed))


def main():
    """Render the frames at the example's parameters (a preview on the
    CPU: `preview_cut`), then mux them."""
    _, device = preview_cut()
    state, system = initial_state(device), MarblesSystem(radius=R)
    hdri = get_hdri("ballroom_8k")
    size = f"{WIDTH}x{HEIGHT}"
    for frame in range(int(os.environ.get("RPT_TPU_FRAMES", str(FRAMES)))):
        r = renderer(device, marble_positions(state), hdri)
        save(r.render(), f"video/image_{frame}.png")
        size = f"{r.width_}x{r.height_}"
        state = system.rk4_integrate(state, FRAME_TIME, STEP)
        print(f"Frame {frame} finished")
    try:
        subprocess.run(["ffmpeg", "-y", "-i", "video/image_%d.png", "-vcodec", "libx264",
                        "-s", size, "-pix_fmt", "yuv420p", "video.mp4"], check=False)
    except FileNotFoundError:
        print("ffmpeg not installed; frames left in video/")


if __name__ == "__main__":
    main()
