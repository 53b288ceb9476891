"""K1/K2 on the dragon's own wavefronts: kernel-only times (CUDA events
around the bare launches, no wrapper) in the wavefront's lane order and
with its rays reordered, and beside another version of the kernel's source.

    python3 tools/profile_torch_traverse.py [--parent DIR] [--reps N]

It renders the dragon scene of `examples/torch_dragon.py` once, records
sample 0's camera and level-1 bounce wavefronts (K1) and its two batched
shadow wavefronts (K2), and times each:

- as the path tracer hands it over (Morton pixel order);
- with the lanes permuted at random, with the entering lanes first, and
  sorted by direction octant and by the Morton cell of the origin: does
  coherence, or packing, pay?
- with ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
  ``git archive`` into a directory that .gitignore lists), that commit's
  `rpt_tpu_torch/csrc/bvh_traverse.cu` built beside this one and timed in
  turns (parent, this, this, parent), its results compared bit for bit.
  The parent's entry points must have the signature of the first port of
  the kernel (outputs after ``active``, then the stream).

Needs one NVIDIA GPU; imports neither jax nor rpt_tpu.
"""

import argparse
import ctypes
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ptr(t):
    return None if t is None else t.data_ptr()


def _wavefronts():
    """The dragon's sample-0 calls of K1 and K2, as (label, any_hit, lanes)
    with lanes a dict of the per-lane tensors."""
    import chip_smoke
    import torch_dragon as dr
    from rpt_tpu_torch import Buffer

    r = dr.renderer("cuda")
    r.sample(1, Buffer(r.width_, r.height_, r.filter_))
    calls = chip_smoke._capture_wavefronts(r)
    out = []
    for label, (args, kwargs) in (("K1 camera", calls["bvh_closest_hit"][0]),
                                  ("K1 level-1 bounce", calls["bvh_closest_hit"][1])):
        names = ("bvh", "o", "d", "t_min", "best_time", "limit", "active")
        lanes = dict(zip(names, args), **kwargs)
        out.append((label, False, {k: lanes.get(k) for k in names}))
    for label, (args, kwargs) in (("K2 level-0 shadows", calls["bvh_any_hit"][0]),
                                  ("K2 level-1 shadows", calls["bvh_any_hit"][1])):
        names = ("bvh", "o", "d", "t_min", "limit", "active")
        lanes = dict(zip(names, args), **kwargs)
        out.append((label, True, {k: lanes.get(k) for k in names}))
    return out


def _launcher(lib, any_hit, w, parent):
    """(launch, outputs) for one wavefront on the bare entry points."""
    n, bvh, dev = w["o"].shape[0], w["bvh"], w["o"].device
    stream = torch.cuda.current_stream().cuda_stream
    head = (w["o"].data_ptr(), w["d"].data_ptr(), n, bvh.nodes.data_ptr(), bvh.leaves.data_ptr(),
            float(w["t_min"]), _ptr(w["limit"]))
    counting = () if parent else (None, None)
    if any_hit:
        outs = [torch.empty(n, dtype=torch.bool, device=dev)]
        return (lambda: lib.rpt_bvh_any_hit(*head, _ptr(w["active"]), outs[0].data_ptr(),
                                            *counting, stream)), outs
    outs = [torch.empty(n, dtype=torch.int32 if j == 1 else torch.float32, device=dev)
            for j in range(5)]
    return (lambda: lib.rpt_bvh_closest_hit(*head, w["best_time"].data_ptr(), _ptr(w["active"]),
                                            *(x.data_ptr() for x in outs), *counting,
                                            stream)), outs


def _permuted(w, perm):
    return {k: (v[perm].contiguous() if isinstance(v, torch.Tensor) and k != "bvh" else v)
            for k, v in w.items()}


def _orders(w):
    """Lane orders to try: name -> permutation."""
    from rpt_tpu_torch.accel.knn import morton_code

    o, d, n = w["o"], w["d"], w["o"].shape[0]
    enter = torch.ones(n, dtype=torch.bool, device=o.device)
    if w["limit"] is not None:
        enter &= w["limit"] > w["t_min"]
    if w["active"] is not None:
        enter &= w["active"]
    gated = (~enter).long() << 60
    octant = ((d[:, 0] < 0).long() << 2) | ((d[:, 1] < 0).long() << 1) | (d[:, 2] < 0).long()
    lo, hi = o.min(0).values, o.max(0).values
    cell = ((o - lo) / (hi - lo).clamp(min=1e-9) * 32).long().clamp(0, 31)
    return int(enter.sum()), {
        "lane order": torch.arange(n, device=o.device),
        "random": torch.randperm(n, device=o.device),
        "entering lanes first": torch.argsort(gated, stable=True),
        "entering first, by direction octant": torch.argsort(gated | (octant << 50), stable=True),
        "entering first, by origin cell (32^3 Morton)": torch.argsort(
            gated | morton_code(cell), stable=True),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="a checkout whose bvh_traverse.cu is timed beside this one")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_traverse: needs an NVIDIA GPU")
    import chip_smoke
    from rpt_tpu_torch.ops import _build

    chip_smoke.phase_device()
    lib = _build.library().lib
    parent = None
    if args.parent:
        src = os.path.join(args.parent, "rpt_tpu_torch", "csrc", "bvh_traverse.cu")
        parent, *_ = _build.compile_and_load("parent_bvh_traverse", [src],
                                             [_build._nvcc(), *_build.NVCC_FLAGS], {})
        parent.rpt_bvh_closest_hit.argtypes = [P, P, I, P, P, F, P, P, P, P, P, P, P, P, P]
        parent.rpt_bvh_any_hit.argtypes = [P, P, I, P, P, F, P, P, P, P]
    for label, any_hit, w in _wavefronts():
        entering, orders = _orders(w)
        print(f"[{label}] {w['o'].shape[0]} lanes, {entering} enter")
        for name, perm in orders.items():
            launch, _ = _launcher(lib, any_hit, _permuted(w, perm), False)
            print(f"    {name:46s} {chip_smoke._time_ms(launch, args.reps):.4f} ms")
        if parent is not None:
            ours, outs = _launcher(lib, any_hit, w, False)
            theirs, ref = _launcher(parent, any_hit, w, True)
            times = [chip_smoke._time_ms(fn, args.reps) for fn in (theirs, ours, ours, theirs)]
            same = all(torch.equal(a, b) for a, b in zip(outs, ref))
            print(f"    parent, this, this, parent: {times[0]:.4f} {times[1]:.4f} {times[2]:.4f} "
                  f"{times[3]:.4f} ms; results bit-equal {same}")


if __name__ == "__main__":
    main()
