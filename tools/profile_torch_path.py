"""Where the time of the port's path-traced renders goes.

    python3 tools/profile_torch_path.py [--scene dragon] [--spp 2] [--size N]
                                        [--device cuda]

Compiles the scene of `examples/torch_dragon.py` (bench.py's dragon
stand-in, ~871k triangles, 2 bounces, 512^2), with ``--scene lampshade``
of `examples/torch_volumetric_pathtrace_lampshade.py` (the media branch,
32 levels, 128^2), or with ``--scene pegasus`` of
`examples/torch_pegasus.py` (the loaded 100,138-triangle pegasus in ice
under the sky, 8 bounces, 1200^2), or with ``--scene marbles`` of the
first frame of `examples/torch_marbles.py` (25 spheres and a monomial
glass, 9 bounces, 800x600), or with ``--scene fractal_spheres`` of
`examples/torch_fractal_spheres.py` (937 spheres and a plane, no bounce,
800x600), traces one untimed warm-up sample,
then ``--spp`` samples under `torch.profiler`, and prints the wall time,
the time the device was busy (the union of its kernels' intervals), that
share of the wall, the number of kernels launched (and a sample) and the
kernels that took the most device time, among them K1
(``closest_hit_kernel``) and K2 (``any_hit_kernel``), and K-rng's
launches and device time (``threefry_*``, the draw form's among them, by
call form) and K-prim's (``prim_closest_hit_kernel``,
``prim_any_hit_kernel``) beside the totals. For the pegasus it
also prints the share of the sky's lookup (`Hdri.get_color`, which the
path makes on every lane of every level): its host time against the
wall, and its kernels' device time against the busy time. Imports
neither jax nor rpt_tpu.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "examples"), os.path.dirname(os.path.abspath(__file__))]

import torch_dragon as dr  # noqa: E402
import torch_fractal_spheres as fractal  # noqa: E402
import torch_marbles as marbles  # noqa: E402
import torch_pegasus as peg  # noqa: E402
import torch_volumetric_pathtrace_lampshade as vol  # noqa: E402
from profile_torch_photon import _profiled  # noqa: E402
from rpt_tpu_torch import sampling  # noqa: E402
from rpt_tpu_torch.renderer import _path_pass  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scene", default="dragon",
                        choices=("dragon", "lampshade", "pegasus", "marbles",
                                 "fractal_spheres"))
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--spp", type=int, default=2)
    args = parser.parse_args()

    annotations = ()
    if args.scene == "dragon":
        r = dr.renderer(args.device, size=args.size or dr.WIDTH, spp=args.spp)
    elif args.scene == "pegasus":
        r = peg.renderer(args.device, size=args.size or peg.WIDTH, sample=args.spp)
        env, annotations = r.scene.environment, ("hdri_lookup",)
        lookup = env.get_color

        def annotated(tables, direction):
            with torch.profiler.record_function("hdri_lookup"):
                return lookup(tables, direction)

        env.get_color = annotated
    elif args.scene == "marbles":
        width = args.size or marbles.WIDTH
        height = width * marbles.HEIGHT // marbles.WIDTH
        r = marbles.renderer(args.device, width=width, height=height, sample=args.spp)
    elif args.scene == "fractal_spheres":
        r = fractal.renderer(args.device)
        if args.size:
            r.width(args.size).height(args.size * fractal.HEIGHT // fractal.WIDTH)
    else:
        r = vol.renderer(args.device, size=args.size or vol.size, sample=args.spp)
    scene, dev = r.compiled, r.device
    key = sampling.key(r.seed_, dev)
    depth = (f"media depth {r.media_max_depth_}" if scene.media
             else f"{r.max_bounces_} bounces")
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"profile: {args.scene} {r.width_}x{r.height_}, {scene.n_tris} triangles, "
          f"{args.spp} spp, {depth} on {card}")

    def trace(s0, n):
        return _path_pass(scene, r.camera, r.width_, r.height_, key, s0, n, r.max_bounces_,
                          r.media_max_depth_)

    trace(0, 1)  # warm-up: builds the kernels and the caching allocator's pools
    _, segments = _profiled(f"trace {args.spp} spp", lambda: trace(1, args.spp), dev,
                            annotations, args.spp)
    print(f"   {segments} ray segments")


if __name__ == "__main__":
    main()
