"""Build and load the port's hand-written CUDA kernels.

Every ``rpt_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
(all started together) into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), for Hopper only (``sm_90a``),
into ``rpt_tpu_torch/_build/`` at first use, and loaded with ctypes. Each
file name carries a hash of its source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited kernel or header is rebuilt
and a stale library is never loaded.

`compile_and_load` is the one compile-and-load path of the package: the
native SAH BVH builder (`csrc/bvh_builder.cpp`, loaded by `accel/bvh.py`)
goes through it with g++.

Each C entry point launches on the stream it is given, checks
``cudaGetLastError()`` right after every launch and returns the first
non-zero code. `launch` is the one way the wrappers call an entry point:
on the current stream, counting the launch under the wrapper's name in
`tracing.LAUNCHES`, then turning a non-zero code into an exception. The
wrappers also share one device guard, `on_card`, and the lane helpers
`lanes` and `lane_tensor`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import torch

from .. import tracing
from ..dtypes import DTYPE

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32

# C signatures of the entry points (pointers and the stream as void*)
_SIGNATURES = {
    # ray_o, ray_d, hit_t, n, records, bounds, n_tiles, ext, scale,
    # med_color, keep, lists, counts, partial, max_blocks, out, stream
    "rpt_sphere_sweep": [_P, _P, _P, _I, _P, _P, _I, _F, _F, _P, _P, _P, _P, _P, _I, _P, _P],
    # ray_o, ray_d, hit_t, n, records, bounds, n_tiles, keep, lists,
    # counts, partial, max_blocks, out_count, stream
    "rpt_sphere_pierced": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P],
    # rows, codes, n, ox, oy, oz, h, inv_h, slack, queries, nq, k, want,
    # out_idx, out_d2, counts, stream
    "rpt_knn_query": [_P, _P, _I, _F, _F, _F, _F, _F, _F, _P, _I, _I, _I, _P, _P, _P, _P],
    # rows, codes, n, ox, oy, oz, h, inv_h, slack, k, want, out_d2, counts,
    # stream
    "rpt_knn_radius": [_P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P],
    # origin, dir, n, nodes, leaves, t_min, limit, best_time, active, out_t,
    # out_tri, out_u, out_v, out_w, ray_counts, warp_counts, stream
    "rpt_bvh_closest_hit": [_P, _P, _I, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # origin, dir, n, nodes, leaves, t_min, limit, active, out_hit,
    # ray_counts, warp_counts, stream
    "rpt_bvh_any_hit": [_P, _P, _I, _P, _P, _F, _P, _P, _P, _P, _P, _P],
    # keys, key_stride, data, data_stride, data_scalar, n, out, stream
    "rpt_threefry_fold": [_P, _I, _P, _I, _U, _I, _P, _P],
    # key, n, out, stream
    "rpt_threefry_split": [_P, _I, _P, _P],
    # keys, n, count, lo, scale, out, stream
    "rpt_threefry_uniform": [_P, _I, _I, _F, _F, _P, _P],
    # keys, n, count, out, stream
    "rpt_threefry_bits": [_P, _I, _I, _P, _P],
    # params (a DrawParams by reference, launched by value), stream
    "rpt_threefry_draw": [_P, _P],
    # params (a PrimParams by reference, launched by value), stream
    "rpt_prim_closest_hit": [_P, _P],
    "rpt_prim_any_hit": [_P, _P],
    # params (a DenseParams by reference, launched by value), stream
    "rpt_dense_closest_hit": [_P, _P],
    "rpt_dense_any_hit": [_P, _P],
    # params (a ShootParams by reference, launched by value), stream
    "rpt_photon_shoot_level": [_P, _P],
    # params (an EstimateParams by reference, launched by value), stream
    "rpt_estimate_prep": [_P, _P],
    "rpt_estimate_pairs": [_P, _P],
    "rpt_estimate_finish": [_P, _P],
}


class KernelLibrary:
    """The entry points of the loaded libraries (``lib.<name>``), their
    paths, the wall time of the parallel build and the compiler's report
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    def __init__(self, lib, paths: list, build_seconds: float, log: str):
        self.lib = lib
        self.paths = paths
        self.build_seconds = build_seconds
        self.log = log


_LIBRARY: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def compile_and_load(stem: str, sources: list[str], command: list[str],
                     signatures: dict) -> tuple:
    """Compile ``sources`` with ``command`` (the compiler and its flags)
    into ``_build/<stem>_<hash>.so`` unless that file exists, load it with
    ctypes and set each entry point's ``(argtypes, restype)`` from
    ``signatures``. The hash covers the flags, the sources and the headers
    beside them (``*.cuh`` in their directories), so an edited source or
    header is rebuilt and a stale library never loaded. A compiler failure
    raises. Returns ``(lib, path, build_seconds, compiler_log)``."""
    digest = hashlib.sha1(" ".join(command[1:]).encode())
    dirs = sorted({os.path.dirname(os.path.abspath(src)) for src in sources})
    headers = sorted(h for d in dirs for h in glob.glob(os.path.join(d, "*.cuh")))
    for src in (*sources, *headers):
        with open(src, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:12]}.so")
    log = ""
    t0 = time.perf_counter()
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([*command, "-o", tmp, *sources], capture_output=True, text=True,
                              timeout=900)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{command[0]} failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib, path, build_seconds, log


def library() -> KernelLibrary:
    """Build (once per process, and only the sources that changed) and load
    the kernel libraries, one ``nvcc`` per source, all in parallel."""
    global _LIBRARY
    if _LIBRARY is None:
        sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        command = [_nvcc(), *NVCC_FLAGS]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sources)) as pool:
            built = list(pool.map(
                lambda src: compile_and_load(os.path.basename(src)[:-3], [src], command, {}),
                sources))
        entry = SimpleNamespace()
        for lib, *_ in built:
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes, fn.restype = args, ctypes.c_int
                    setattr(entry, name, fn)
        missing = sorted(set(_SIGNATURES) - set(vars(entry)))
        if missing:
            raise RuntimeError(f"kernel entry points missing from {CSRC_DIR}: {missing}")
        _LIBRARY = KernelLibrary(entry, [b[1] for b in built], time.perf_counter() - t0,
                                 "".join(b[3] for b in built))
    return _LIBRARY


def launch(name: str, entry: str, on: torch.Tensor, *args) -> None:
    """Call the entry point ``entry`` with ``args`` and the current stream
    of the device of ``on``, count the launch under the wrapper's ``name``
    (`tracing.count`), then raise on a non-zero CUDA status."""
    code = getattr(library().lib, entry)(*args, torch.cuda.current_stream(on.device).cuda_stream)
    tracing.count(name)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def on_card(name: str, t: torch.Tensor, n_lanes: int = 0) -> None:
    """Refuse a tensor off the card, and ``n_lanes`` past what the kernels
    count in int32."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if n_lanes >= 1 << 31:
        raise ValueError(f"{name}: {n_lanes} lanes; the kernel counts them in int32")


def lanes(name: str, like: torch.Tensor, ray) -> tuple:
    """The six components of ``ray`` (a `Ray`) broadcast to one lane shape
    and flattened (views where they can be), and that shape; they must be
    float32 on the device of the table ``like`` and, off the CPU, pass
    `on_card`."""
    comps = torch.broadcast_tensors(ray.origin.x, ray.origin.y, ray.origin.z,
                                    ray.dir.x, ray.dir.y, ray.dir.z)
    for c in comps:
        if c.dtype != DTYPE:
            raise ValueError(f"{name}: ray components must be float32, got {c.dtype}")
        if c.device != like.device:
            raise ValueError(f"{name}: the ray is on {c.device}, the rows on {like.device}")
    flat = [c.reshape(-1) for c in comps]
    if like.device.type != "cpu":
        on_card(name, like, flat[0].shape[0])
    return flat, comps[0].shape


def lane_tensor(name: str, what: str, x, dtype, shape, dev) -> torch.Tensor:
    """``x`` (a number or a tensor that broadcasts against the lanes) as a
    flat view over the lanes, of ``dtype`` on ``dev``."""
    if isinstance(x, torch.Tensor) and (x.dtype != dtype or x.device != dev):
        raise ValueError(f"{name}: {what} must be {dtype} on {dev}, got {x.dtype} on {x.device}")
    return torch.as_tensor(x, dtype=dtype, device=dev).expand(shape).reshape(-1)
