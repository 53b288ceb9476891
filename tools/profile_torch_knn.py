"""K-knn's query kernel on the photon-map lampshade's own gathers, at every
list width, beside another version of the kernel's source.

    python3 tools/profile_torch_knn.py [--parent DIR] [--ks 20,30,50,64,100,128] [--reps N]

It renders one sample of `examples/torch_volumetric_photonphoton_lampshade
.py` (1M photons: ~1.49M surface and ~0.72M volume photons), forms sample
0's surface gather points (16,384, misses at the origin) and, for each k,
holds the kernel to `knn_plain` (sorted d^2 bit-equal, indices distinct
and at their distances), times the bare entry point with CUDA events, and
prints its counting variant's levels, cells and candidates a query.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
``git archive`` into a directory that .gitignore lists), that commit's
`rpt_tpu_torch/csrc/knn.cu` is built beside this one, with one entry
point added that launches its query kernel's counting variant with the
list it dispatches for k > 32 (`LocalLists<128>` up to this kernel's
first redesign of k > 32; `PARENT_LIST`), and each k is timed in turns
(parent, this, this, parent), its d^2 compared bit for bit, and its counts
printed beside these.

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
QUERY_ARGS = [P, P, I, F, F, F, F, F, F, P, I, I, I, P, P, P, P]
PARENT_LIST = "LocalTopK<128>, LocalLists<128>"
PARENT_ENTRY = """
#include "{src}"

// the query kernel's counting variant with the list the source dispatches for k > 32
extern "C" int rpt_knn_query_wide_counts(const float* rows, const long long* codes, int n,
        float ox, float oy, float oz, float h, float inv_h, float slack, const float* queries,
        int nq, int k, int want, int* out_idx, float* out_d2, int* counts, void* stream) {{
    const Grid g{{reinterpret_cast<const float4*>(rows), codes, n, ox, oy, oz, h, inv_h, slack}};
    return static_cast<int>(launch_query<{lst}, true>(g, queries, nq, k, want, out_idx, out_d2,
                                                      counts, static_cast<cudaStream_t>(stream)));
}}
"""


def _parent_library(parent: str):
    """The parent's knn.cu, built with the added counting entry point (or,
    where that does not compile, without it: then no parent counts)."""
    from rpt_tpu_torch.ops import _build

    src = os.path.abspath(os.path.join(parent, "rpt_tpu_torch", "csrc", "knn.cu"))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    wrapper = os.path.join(_build.BUILD_DIR, "parent_knn_counts.cu")
    with open(wrapper, "w") as f:
        f.write(PARENT_ENTRY.format(src=src, lst=PARENT_LIST))
    command = [_build._nvcc(), *_build.NVCC_FLAGS]
    try:
        lib, *_ = _build.compile_and_load("parent_knn_counts", [wrapper], command, {})
        lib.rpt_knn_query_wide_counts.argtypes = QUERY_ARGS
        wide = lib.rpt_knn_query_wide_counts
    except RuntimeError as e:
        print(f"[parent] the counting entry point did not build ({str(e)[:200]}); "
              "timing the parent without counts")
        lib, *_ = _build.compile_and_load("parent_knn", [src], command, {})
        wide = None
    lib.rpt_knn_query.argtypes = QUERY_ARGS
    return lib.rpt_knn_query, wide


def _launcher(entry, grid, q, k, counts=None):
    """(launch, idx, d2) on a bare entry point."""
    from rpt_tpu_torch.accel.knn import _grid_args, want_points

    n = q.shape[0]
    idx = torch.empty((n, k), dtype=torch.int32, device=q.device)
    d2 = torch.empty((n, k), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (*_grid_args(grid), q.data_ptr(), n, k, want_points(k), idx.data_ptr(), d2.data_ptr(),
            None if counts is None else counts.data_ptr(), stream)

    def launch():
        code = entry(*args)
        if code:
            raise RuntimeError(f"K-knn launch failed with cudaError {code}")

    return launch, idx, d2


def _count_line(c) -> str:
    import chip_smoke

    return (f"levels {chip_smoke._quantiles(c[:, 0])} (mean {float(c[:, 0].float().mean()):.2f}); "
            f"cells {chip_smoke._quantiles(c[:, 1])} (mean {float(c[:, 1].float().mean()):.1f}); "
            f"candidates {chip_smoke._quantiles(c[:, 2])} (mean "
            f"{float(c[:, 2].float().mean()):.1f})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="a checkout whose knn.cu is timed beside this one")
    parser.add_argument("--ks", default="20,30,50,64,100,128")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_knn: needs an NVIDIA GPU")
    import chip_smoke
    import torch_volumetric_photonphoton_lampshade as ex
    from rpt_tpu_torch.accel.knn import knn_plain, knn_query_counts
    from rpt_tpu_torch.ops import _build

    chip_smoke.phase_device()
    this = _build.library().lib.rpt_knn_query
    parent, parent_counts = _parent_library(args.parent) if args.parent else (None, None)

    r = ex.renderer("cuda", sample=1, seed=0)
    r.photon_map_render(ex.photons)
    grid = r.photon_map.surface_grid
    ray, _, hit = chip_smoke._sample0(r)
    q = torch.where(hit.valid[:, None], ray.at(hit.time).to_array(), 0.0).contiguous()
    print(f"[K-knn] photon-map lampshade, sample 0's surface gather: {q.shape[0]} queries "
          f"({int((~hit.valid).sum())} misses at the origin) x {grid.n} surface photons")
    for k in (int(v) for v in args.ks.split(",")):
        launch, idx, d2 = _launcher(this, grid, q, k)
        launch()
        _, d2p, _ = knn_plain(grid.points, q, k)
        valid = torch.isfinite(d2)
        at = ((grid.points[torch.where(valid, idx.long(), 0)] - q[:, None, :]) ** 2).sum(-1)
        ranked = torch.sort(torch.where(valid, idx, -1 - torch.arange(k, device=q.device,
                                                                     dtype=idx.dtype)), 1).values
        consistent = bool(torch.isclose(torch.where(valid, at, d2), d2, rtol=1e-6, atol=0.0).all()
                          and (ranked[:, 1:] != ranked[:, :-1]).all())
        exact = float((d2 == d2p).all(dim=1).float().mean())
        print(f"[K-knn] k={k}: rows bit-equal to brute force {exact:.5f}, indices consistent "
              f"{consistent}; kernel {chip_smoke._time_ms(launch, args.reps):.4f} ms")
        print(f"    counts: {_count_line(knn_query_counts(grid, q, k))}")
        if parent is None:
            continue
        theirs, _, pd2 = _launcher(parent, grid, q, k)
        times = [chip_smoke._time_ms(fn, args.reps) for fn in (theirs, launch, launch, theirs)]
        print(f"    parent, this, this, parent: {' '.join(f'{t:.4f}' for t in times)} ms; d^2 "
              f"bit-equal to the parent's {bool(torch.equal(pd2, d2))}")
        if parent_counts is not None and k > 32:
            c = torch.zeros((q.shape[0], 4), dtype=torch.int32, device=q.device)
            _launcher(parent_counts, grid, q, k, c)[0]()
            print(f"    parent counts: {_count_line(c)}")
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
