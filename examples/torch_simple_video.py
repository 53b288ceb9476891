"""A frame sequence with the scene rebuilt each frame on the PyTorch port
(`examples/simple_video.py`, from `simple_video.rs`): the scene of
`basic.py` with its box 0.01 further away each frame, 800x600, 100 spp,
1 bounce, 60 frames (RPT_TPU_FRAMES caps them), muxed with ffmpeg where it
is installed:

    python examples/torch_simple_video.py
"""

import os
import subprocess

from _torch_assets import preview_cut, save
from torch_basic import add_primitives

import rpt_tpu_torch as rpt

WIDTH, HEIGHT, SPP, MAX_BOUNCES, FRAMES = 800, 600, 100, 1, 60


def build_scene(frame: int) -> rpt.Scene:
    """`examples/simple_video.py:15-45`: the box at depth 4 + 0.01 frame."""
    scene = rpt.Scene()
    add_primitives(scene, box_z=4.0 + 0.01 * frame)
    return scene


def renderer(device="cuda", frame=0, seed=0) -> rpt.Renderer:
    """Frame ``frame``'s renderer on ``device``."""
    return (rpt.Renderer(build_scene(frame), rpt.Camera(), device=device).width(WIDTH)
            .height(HEIGHT).num_samples(SPP).max_bounces(MAX_BOUNCES).seed(seed))


def main():
    """Render the frames at the example's parameters (a preview on the
    CPU: `preview_cut`), then mux them."""
    _, device = preview_cut()
    os.makedirs("video", exist_ok=True)
    for i in range(int(os.environ.get("RPT_TPU_FRAMES", str(FRAMES)))):
        save(renderer(device, i).render(), f"video/image_{i}.png")
    try:
        subprocess.run(["ffmpeg", "-y", "-i", "video/image_%d.png", "-vcodec", "libx264",
                        "-s", f"{WIDTH}x{HEIGHT}", "-pix_fmt", "yuv420p", "video.mp4"],
                       check=False)
    except FileNotFoundError:
        print("ffmpeg not installed; frames left in video/")


if __name__ == "__main__":
    main()
