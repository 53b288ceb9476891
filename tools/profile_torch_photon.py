"""Where the time of the port's photon renders goes.

    python3 tools/profile_torch_photon.py [--kind point_beam] [--spp 5]
                                          [--photons N] [--size N]
                                          [--device cuda] [--cornell | --skybox]

Runs the three phases of a lampshade photon example (``--kind``:
`examples/torch_volumetric_beamphoton_lampshade.py` for ``point_beam``,
`..._photonphoton_...` for ``photon_map``, `..._beambeam_...` for
``beam_beam``), or with ``--cornell`` of `examples/torch_photon_map.py`
(the photon-map kind in a Cornell box with no medium, gather 50 / 50),
or with ``--skybox`` of `examples/torch_skybox_photons.py` (the
photon-map kind in the open foggy box under the sky, gather 50 / 50 over
both clouds), at the example's own size and photon count unless ``--size`` and
``--photons`` say otherwise (shoot, map build, camera pass) one after the
other under
`torch.profiler`, and prints for each phase its wall time, the time the
device was busy (the union of its kernels' intervals on the device
timeline), that share of the wall, the number of kernels launched, and
the kernels that took the most device time, and K-rng's launches by call
form (fold, split, uniform, bits and the draw form). Imports neither jax
nor rpt_tpu. The first phase run builds the CUDA kernels if they are not
built yet, so the kernels are built before profiling starts.
"""

import argparse
import collections
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "examples")]

import numpy as np  # noqa: E402
import torch_photon_map  # noqa: E402
import torch_skybox_photons  # noqa: E402
import torch_volumetric_beambeam_lampshade  # noqa: E402
import torch_volumetric_beamphoton_lampshade  # noqa: E402
import torch_volumetric_photonphoton_lampshade  # noqa: E402
from rpt_tpu_torch import sampling  # noqa: E402
from rpt_tpu_torch.integrators import photon as ph  # noqa: E402
from rpt_tpu_torch.renderer import _photon_pass  # noqa: E402


EXAMPLES = {ph.POINT_BEAM: torch_volumetric_beamphoton_lampshade,
            ph.PHOTON_MAP: torch_volumetric_photonphoton_lampshade,
            ph.BEAM_BEAM: torch_volumetric_beambeam_lampshade}


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (us in)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _rng_form(kernel_name: str) -> str:
    """K-rng's call form of one of its kernels (`csrc/threefry.cu`): fold,
    split, uniform, bits or draw."""
    form = kernel_name.split("threefry_", 1)[1].split("_kernel", 1)[0]
    if form == "words":
        return "bits" if "<true>" in kernel_name else "uniform"
    return form


def _kernels_under(event):
    """(kernels, device us) launched under a host event and its children."""
    n, us = len(event.kernels), sum(k.duration for k in event.kernels)
    for child in event.cpu_children:
        cn, cus = _kernels_under(child)
        n, us = n + cn, us + cus
    return n, us


def _profiled(name, fn, device, annotations=(), samples=None):
    """Run ``fn`` once under the profiler; print the phase's line and its
    top kernels; return ``fn``'s result. For each name in ``annotations``
    (a `torch.profiler.record_function` range that ``fn`` opens), also
    print its calls, its host time and the kernels launched under it with
    their device time, against the phase's wall and device-busy time: host
    op events are then recorded too. With ``samples``, also print the
    kernels launched a sample."""
    # device activity only unless ranges are asked for: host-side op events
    # would cost minutes to collect over the shoot's ~10^6 launches
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    if annotations and device.type == "cuda":
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # a range's own device-side marker is not a kernel
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in annotations]
    busy = _busy_ms((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    print(f"== {name}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100.0 * busy / wall:.1f}%), kernels launched {len(kernels)}"
          + (f" ({len(kernels) / samples:.0f} a sample)" if samples else ""))
    for kname, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"   {ms:10.1f} ms {count:8d}x  {kname[:90]}")
    rng = {kname: v for kname, v in by_name.items() if "threefry_" in kname}
    rng_ms = sum(ms for ms, _ in rng.values())
    rng_n = sum(count for _, count in rng.values())
    forms = collections.Counter()
    for kname, (_, count) in rng.items():
        forms[_rng_form(kname)] += count
    print(f"   K-rng (threefry_* kernels): {rng_n} launches"
          + (f" ({rng_n / samples:.0f} a sample)" if samples else "")
          + f" of {len(kernels)}, {rng_ms:.1f} ms device ({100.0 * rng_ms / max(busy, 1e-9):.1f}%"
          f" of the busy time); by form: "
          + (", ".join(f"{form} {n}" for form, n in sorted(forms.items())) or "none"))
    prim = {kname: v for kname, v in by_name.items()
            if "prim_closest_hit_kernel" in kname or "prim_any_hit_kernel" in kname}
    print(f"   K-prim (prim_*_hit_kernel): "
          + (", ".join(f"{'any hit' if 'any' in kname else 'closest hit'} {count} launches"
                       + (f" ({count / samples:.0f} a sample)" if samples else "")
                       + f", {ms:.2f} ms device" for kname, (ms, count) in sorted(prim.items()))
             or "none"))
    for label in annotations:
        ranges = [e for e in events if e.name == label
                  and e.device_type == torch.autograd.DeviceType.CPU]
        host = sum(e.time_range.elapsed_us() for e in ranges) / 1e3
        n = us = 0
        for e in ranges:
            en, eus = _kernels_under(e)
            n, us = n + en, us + eus
        print(f"   range {label}: {len(ranges)} calls, host {host:.1f} ms "
              f"({100.0 * host / wall:.1f}% of the wall), {n} kernels, device {us / 1e3:.1f} ms "
              f"({100.0 * us / 1e3 / max(busy, 1e-9):.1f}% of the busy time)")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--kind", default=ph.POINT_BEAM, choices=sorted(EXAMPLES))
    parser.add_argument("--cornell", action="store_true",
                        help="examples/torch_photon_map.py (the photon-map kind)")
    parser.add_argument("--skybox", action="store_true",
                        help="examples/torch_skybox_photons.py (the photon-map kind in fog)")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--photons", type=int, default=None)
    parser.add_argument("--spp", type=int, default=5)
    args = parser.parse_args()

    if args.skybox:
        ex, args.kind, scene_name = torch_skybox_photons, ph.PHOTON_MAP, "skybox"
        args.size, args.photons = args.size or ex.SIZE, args.photons or ex.PHOTONS
    else:
        ex = torch_photon_map if args.cornell else EXAMPLES[args.kind]
        scene_name = "cornell" if args.cornell else "lampshade"
        if args.cornell:
            args.kind = ph.PHOTON_MAP
        args.size, args.photons = args.size or ex.size, args.photons or ex.photons
    # the photon-map examples' watts do not scale with the photon count
    scaled = {} if args.kind == ph.PHOTON_MAP else {"photons": args.photons}
    r = ex.renderer(args.device, size=args.size, sample=args.spp, **scaled)
    scene, dev = r.compiled, r.device
    if dev.type == "cuda":
        from rpt_tpu_torch.ops import _build

        _build.library()
    key = sampling.key(r.seed_, dev)
    print(f"profile: {scene_name} {args.kind} {args.size}^2, "
          f"{args.photons} photons, gather "
          f"{r.gather_size_} / {r.gather_size_volume_}, {args.spp} spp on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    photons = _profiled("shoot", lambda: ph.shoot_photons_device(
        scene, scene.tables, sampling.fold_in(key, 1), args.photons, r.watts_), dev)
    pmap = _profiled("build", lambda: ph.build_photon_map(
        scene, scene.tables, photons.surface, photons.volume, args.kind, r.gather_size_,
        r.gather_size_volume_, np.random.default_rng(r.seed_ + 17)), dev)
    _profiled(f"trace {args.spp} spp", lambda: _photon_pass(
        scene, r.camera, r.width_, r.height_, pmap, sampling.fold_in(key, 2), args.spp,
        r.gather_size_, r.gather_size_volume_, True), dev)


if __name__ == "__main__":
    main()
