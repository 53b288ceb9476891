"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--spp N] [--vol-spp N]

Builds the hand-written CUDA kernels from `rpt_tpu_torch/csrc` (one nvcc
per source, in parallel) and drives every ported path end to end:

- `[K-rng]` first: the threefry2x32 RNG (`csrc/threefry.cu`) against its
  plain version (int64 torch ops) in every call form the paths make
  (fold of one key with a tensor of wide data, of a batch with an int and
  with a batch, of (A, B) keys; split; uniform at three ranges, uniform2,
  uniform3; the raw words; the draw form, a key's chain of folds and its
  draws in one launch, as the camera, `sample_f`, a light sampler and a
  materialised chain call it) at 262,144 lanes and
  at the photon shoot's chunk of 2^19, bit for bit on every element, each
  timed on the device and on the host beside its plain version and its
  bound; then the 32^2 point-beam and the Cornell golden renders, once as
  shipped and once with K-rng's wrappers patched here to the plain
  versions, bit-equal. Every path below draws its numbers through K-rng:
  its launches are read with the path's other counts, and each path must
  have drawn its floats through the draw form (a photon shoot also split
  keys);
- the point-photon x beam-query path at the lampshade example's own
  parameters; it launches K-sweep (once per camera wavefront) and K-knn
  (one self-query launch for the photon radii, one gather per wavefront),
  which are then held against their plain PyTorch versions on the
  render's real tables (K-knn's radius pass on 4096 random photons and
  the 1024 of largest radius; K-sweep also on a ragged random case and on far
  small spheres, where float32 cancellation matters: the estimate, bit
  equality across two calls, the pierced pairs of every ray, and the
  tiles its cull keeps), and a small render is checked against its
  golden image;
- the path tracer on the dragon scene of `bench.py` at its full size
  (~871k triangles, 512x512, 8 spp, 2 bounces); it launches K1 (closest
  hit) and K2 (any hit), which are then held against their plain versions
  on the render's own camera, bounce and shadow wavefronts, and the
  sphere and Cornell renders are checked against their golden images;
- the photon-map (point query) kind at its lampshade example's own
  parameters (gather 100 / 30); it launches K-knn twice per camera
  wavefront, over the surface cloud at k = 100 (a warp's list four
  registers a lane) and over the volume cloud at k = 30 (one), and both
  are held against brute force on a real wavefront's queries, the surface
  queries also at k = 50, 64 and 128;
- `examples/torch_photon_map.py` (`photon_map.py`: 512x512, 10 spp, 10M
  photons) at its full size with `Renderer`'s default gather, 50 / 50:
  K-knn at k = 50 (two registers a lane) once per wavefront over the
  surface photons, held against brute force on a wavefront's queries;
- `examples/torch_skybox_photons.py` (`skybox_photons.py`: the open
  foggy box under a sky, 256x256, 100 spp, 10M photons, gather 50 / 50)
  at its full size: two K-knn gathers at k = 50 a wavefront, over the
  surface photons and at the sampled collision over the volume photons,
  both held against brute force on sample 0's queries; the pixels through
  the ceiling's opening lit; then `[K-estimate]` (`csrc/photon_estimate.cu`,
  the estimates around the gathers): the skybox's first 16,384-lane
  wavefront (the point query, k = 50 / 50) and the point-beam lampshade's
  (the surface estimate, k = 20) through the kernel and the chain
  (`point_plain`, `surface_plain`), bit for bit, timed beside it and its
  bound; every path that estimates from a photon map on the card must
  launch it (prep and finish once an estimate);
- the beam x beam kind at its example's parameters; its beam estimate is
  torch ops, timed and held against a beam-by-beam float64 reference on
  256 lanes, and the sphere sweep of a medium whose phase depends on the
  directions (torch ops too) is timed on the point-beam render's spheres;
- `examples/torch_pegasus.py` (`pegasus.py`) at its full size: the
  100,138 triangles of `data/pegasus.obj` loaded by the port's loader, in
  ice under the sky (`Hdri`; the procedural one, no `.hdr` being in the
  repository), 1200x1200, 10 spp, 8 bounces; K1 is held against its plain
  version on a camera chunk of sample 0 and on its level-1 and level-2
  bounces (rays on and inside the ice), K2 on a sun-shadow wavefront built
  from that chunk's hits (the scene has no light, so the path casts no
  shadow ray), and `Hdri.get_color` on the card against the CPU on the
  sample's misses;
- `rpt_tpu_torch.parallel` at world size 1 over NCCL in this process
  (`[sharded]`): ``render_sharded`` on the dragon at its full size, and
  ``shoot_photons_sharded`` (1M photons) and ``photon_render_sharded`` on
  the point-beam lampshade, each against the single-process pass (the
  shoot bit for bit), with the launches of K1, K2, K-sweep and K-knn
  that the sharded calls made;
- `examples/torch_teapot.py` at its full size (800x800, the loaded
  2,256-triangle teapot under a point light): K1 and K2 on its camera and
  shadow wavefronts;
- `examples/torch_marbles.py`'s first two frames (800x600, 9 bounces, the
  samples cut by ``--spp``, 16 when left out) with one frame's RK4
  integration of `MarblesSystem` between them, timed on the card;
- `examples/torch_fractal_spheres.py` at its full size (`[fractal-spheres]`:
  800x600, 1 spp, 937 spheres and a plane, three lights): every closest
  hit and shadow query through K-prim (`csrc/prim_hit.cu`), one launch a
  query, and no per-type prim test on the card; then `[K-prim]`: the
  kernel against the per-type chain on wavefronts captured from the
  renders' own passes (the fractal's camera chunk and shadow wavefront, a
  marbles bounce, a volumetric-lampshade level, the `monomial_glass`
  camera chunk), with the lanes that are bit-equal;
- the volumetric path tracer on the lampshade at its example's width
  through `iterative_render`, its 1000 samples cut by ``--vol-spp``;
  then `[K-dense]` (`csrc/dense_tri_hit.cu`, the dense test of the
  lampshade's 12 triangles): every dense query of a 128^2 volumetric path
  pass and of a 1M-photon point-beam render replayed through the kernel
  and the chain of torch ops, bit for bit, and six of the wavefronts
  (camera, bounce and shadow levels; the shoot, the camera pass and the
  occlusion recheck) timed beside the chain and their bound;
- `[K-shoot]` (`csrc/photon_shoot.cu`, a shoot level's interaction):
  the skybox shoot's first chunk of 500,000 photons level by level, its
  level 0 and a late level held bit for bit to the chain
  (`shoot_level_plain`) and timed beside it and their bound; its calls a
  render are those the skybox and point-beam renders made (every path
  that shoots photons on the card must launch it);
- the three media goldens (volumetric path, photon map, beam-beam);
- 17 drivers that no other phase renders (`[drivers]`), each built by its
  ``renderer("cuda")`` and cut to a quarter of its size and 2 spp.

The K-rng entries of the kernel report (fold, split, uniform, draw) carry
the launches of every path by path (``launches_by_path``) and their sum;
``random_bits``, which no path calls, rides as side fields of uniform's,
and uniform itself, whose call sites the draw form took, has none.
The counting variants of K-knn, K1 and K2 print what a query or a ray
costs (levels, cells and candidates; steps, leaf slots and the warps'
live-lane share). A K-knn gather is timed on every wavefront of a sample,
captured from the render's own pass, with L2 evicted before each call (as
between the render's launches) and warm; its bound counts the distinct
points among its answers. A K-knn entry's launches are its path's
gathers at its k; gathers that no path makes (k = 64 and 128, and k = 50
on the lampshade) ride as side fields of the entry of their list. The
pegasus's and the teapot's K1/K2 numbers ride as side fields of the
dragon's K1/K2 entries (``pegasus_*``, ``pegasus_bounce_*``,
``pegasus_sun_shadow_*``, ``teapot_*``, with each path's launches), as do
the launches of the sharded calls (``sharded_launches``) and of the
drivers (``drivers_launches``). K-prim's two entries carry the fractal's
launches and every path's (``launches_by_path``: every path tests its rays
against the analytic prims through K-prim, a scene without any included),
the fractal's camera (closest hit) and shadow (any hit) times, and the
other wavefronts' times as side fields. K-dense's two entries carry the
volumetric path's launches (``launches``, ``--vol-spp`` samples), the
50-spp point-beam render's (``render_launches``) and every path's that
made any (``launches_by_path``). The skybox's volume gather is an entry of
its own (``knn_query_k50_volume``), its surface gather side fields of it.

Every phase prints its lines; any failure raises and exits non-zero. The
launch counts of each path are set to 0 just before it and read just
after. The last three lines are the kernel report (JSON: each kernel's
launches on its path, its time, its plain version's, and its bound, the
larger of its bytes at the HBM rate and its operations at the float32
rate, K-rng's int32 operations at half that rate), the card's name and power limit, and the device report (JSON). It
imports neither jax nor rpt_tpu, and exits non-zero without a result
where CUDA is unavailable or the repository is not beside it.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "lampshade_pointbeam_32.npy")
# The beam estimate and the directional sweep against their references:
# 1 - cos^2 (a ray a few degrees from a beam) and oc^2 - dd^2 cancel in
# float32, so rtol 1e-3 (atol 1e-6 of the largest value) on >= 99% of lanes.
ESTIMATE_RTOL = 1e-3
ESTIMATE_AGREEMENT = 0.99
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

# K-sweep sums up to ~2M FP32 terms per ray in another order than the
# plain version's chunked matrix product: rtol 1e-3 (atol 1e-6 of the
# largest value, for rays that pierce nothing).
SWEEP_RTOL = 1e-3
# K-knn and brute force compute d^2 with the same rounded operations: the
# sorted distances must agree on >= 99.9% of rows.
KNN_ROW_AGREEMENT = 0.999
# K1/K2 and their plain versions round the same operations, but f32
# grazing-edge hits flip about 1 lane in 262k between engines: the same
# triangle (K1) or flag (K2) on >= 99.99% of lanes.
TRAVERSE_AGREEMENT = 0.9999
# Where K1's triangle agrees, its t, u, v, w come from the same rounded
# operations as the plain version's: rtol 1e-6, and for the barycentrics
# (in [0, 1], often near 0) atol 1e-6 besides.
HIT_RTOL = 1e-6
BARY_ATOL = 1e-6


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# A write this large evicts the H100's 50 MB L2 before a cold call.
L2_EVICT_BYTES = 1 << 30


def _cold_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card with its data out of L2, as
    between a render's launches, where the pass's other work evicts it:
    before each call a write of `L2_EVICT_BYTES` (which also keeps the card
    busy while the host issues the call); CUDA events bracket the call
    alone. One warm-up call first."""
    scratch = torch.empty(L2_EVICT_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        scratch.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = "nvcc not found"
    for cand in ("nvcc", "/usr/local/cuda/bin/nvcc"):
        try:
            out = subprocess.run([cand, "--version"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout
            nvcc = [line for line in out.splitlines() if "release" in line][0].strip()
            break
        except (OSError, subprocess.CalledProcessError):
            continue
    print(f"[device] {smi} | torch {torch.__version__} (CUDA {torch.version.cuda}) | {nvcc}")
    return smi


def _knn_kernel(line: str) -> str:
    """A K-knn kernel's name and lists from ptxas's line for its mangled
    entry function."""
    kind = "query" if "knn_query_kernel" in line else "radius"
    lists = [f"RegTopK<{n}>" for n in re.findall(r"RegTopKILi(\d+)E", line)]
    lists += [f"WarpListR<{n}>" for n in re.findall(r"WarpListRILi(\d+)E", line)]
    return f"{kind}<{', '.join(lists)}>"


def phase_build():
    from rpt_tpu_torch.ops import _build

    lib = _build.library()
    usage = [line.strip() for line in lib.log.splitlines() if "registers" in line]
    paths = ", ".join(os.path.relpath(p, ROOT) for p in lib.paths)
    print(f"[build] {paths} in {lib.build_seconds:.2f} s; "
          f"ptxas: {' | '.join(usage) if usage else 'cached'}")
    # K-knn keeps its lists in registers: the query kernel's one list
    # across a warp's lanes (one, two or four entries a lane: k <= 32, 64,
    # 128) and the self-query's list a lane for k = 10 and k = 20. ptxas
    # must report no stack frame and no spill for each of these five.
    lines = lib.log.splitlines()
    found = [(_knn_kernel(line), lines[i + 2].strip(),
              lines[i + 3].split(":")[-1].split(",")[0].replace("Used", ""))
             for i, line in enumerate(lines[:-3])
             if "Compiling entry function" in line and "Lb0E" in line
             and ("RegTopK" in line or "WarpListR" in line)]
    frames = [frame for _, frame, _ in found]
    local = [f for f in frames if not f.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                                   "0 bytes spill loads")]
    draw = [lines[i + 2].strip() + "; " + lines[i + 3].strip()
            for i, line in enumerate(lines[:-3])
            if "Compiling entry function" in line and "threefry_draw_kernel" in line]
    print(f"[build] K-rng's draw form (chain and draws from the parameter struct): {draw}")
    print(f"[build] K-knn kernels with the list in registers: "
          f"{'; '.join(f'{name}{regs}' for name, _, regs in found)}; of which with local "
          f"memory: {len(local)} {local}")
    if usage and (len(frames) != 5 or local):
        raise RuntimeError("a K-knn kernel whose list should lie in registers uses local memory")


def phase_render(spp_cap):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_volumetric_beamphoton_lampshade as ex

    spp = _cut(ex.sample, spp_cap)
    r = ex.renderer("cuda", sample=spp, seed=0)
    _zero_counts()
    img = r.photon_point_query_beam_render(ex.photons)
    launches = {name: _launched(name) for name in ("sphere_sweep", "knn_query", "knn_radius")}
    rng = _read_rng("render", shoots=True)
    prims = _read_prim("render")
    dense = _read_dense("render", required=True)
    shoot = _read_shoot("render", required=True)
    estimate = _read_estimate("render", required=True)
    s, c = r.phase_seconds, r.photon_counts
    finite = bool(np.isfinite(r._last_buffer.raw()).all())
    note = "" if spp == ex.sample else f" (spp lowered from {ex.sample} to {spp})"
    print(f"[render] {r.width_}x{r.height_} {spp} spp{note}, {ex.photons} photons: shoot "
          f"{s['shoot']:.3f} s, build {s['build']:.3f} s, trace {s['trace']:.3f} s; "
          f"surface {c['surface']}, volume {c['volume']}, dropped {c['dropped']}; "
          f"image mean {img.mean():.4f}, finite {finite}; launches {launches}, K-rng {rng}, "
          f"K-prim {prims}, K-dense {dense}, K-shoot {shoot}, K-estimate {estimate}")
    if not finite or img.shape != (r.height_, r.width_, 3) or img.mean() <= 0:
        raise RuntimeError("render output is not a finite, non-black image of the right shape")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the render never launched {name}")
    if launches["sphere_sweep"] != _wavefronts(r, spp):
        raise RuntimeError(f"K-sweep launched {launches['sphere_sweep']} times for {spp} "
                           "samples, not once per wavefront")
    if launches["knn_radius"] != 1:
        raise RuntimeError(f"the radius pass took {launches['knn_radius']} launches, not one")
    return r, ex, launches


# The card's peaks for the bounds (H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores.
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K-sweep's operations, counted from `csrc/sphere_sweep.cu`: a pair test
# (3 sub, 6 mul, 4 add, dd*dd, sub, clamp, 3 compares), a weighted pierced
# pair (2 divisions, exp, 3 multiply-adds, ...) and a (ray, tile) cull test
# (box distance, two square roots, the inflated radius, three slabs). Its
# bound counts only the pierced pairs, the work any design must do; the
# pair and tile tests are this design's way of finding them.
PAIR_OPS, PIERCED_OPS, TILE_TEST_OPS = 20, 30, 60


def _cut(sample: int, cap) -> int:
    """An example's sample count, cut to ``--spp`` where that was given."""
    return sample if cap is None else min(sample, cap)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of moving ``n_bytes`` at the HBM
    rate and doing ``n_ops`` at ``ops_per_s`` (the float32 rate)."""
    t_bytes, t_ops = n_bytes / MEM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# K-rng: the sizes of its check (a dragon wavefront's 512^2 lanes, and the
# photon shoot's chunk of 2^19), its operations counted from
# `csrc/threefry.cu` (a hash: 20 rounds of add, funnel shift and xor, five
# key injections of three adds, two initial adds, the schedule's two xors;
# uniform maps a word with xor, shift, or, sub, mul and add), and the
# int32 rate: 64 int32 lanes a multiprocessor, one instruction a clock,
# over the 132 multiprocessors at the 1.98 GHz boost clock (the float32
# rate counts 128 lanes a multiprocessor and a fused multiply-add as two).
RNG_SIZES = (1 << 18, 1 << 19)
HASH_OPS = 20 * 3 + 5 * 3 + 2 + 2
MAP_OPS = 6
INT32_OPS_PER_S = 132 * 64 * 1.98e9
RNG_WRAPPERS = ("threefry_fold", "threefry_split", "threefry_uniform", "threefry_bits",
                "threefry_draw")
# K-rng launches of every path the smoke drives, by path (`_read_rng`)
RNG_LAUNCHES: dict = {}
# Cycles of `torch.cuda._sleep` (about 10 ms at the H100's clocks) that
# hold the card while the host enqueues the call timed behind them.
HOLD_CYCLES = 20_000_000


def _device_ms(fn, reps: int = 5):
    """Mean device time of one call of ``fn``, its inputs warm in L2, and
    the host's longest enqueue of it: before each call `HOLD_CYCLES` of
    sleep keep the card busy while the host enqueues the call, so the CUDA
    events around it bracket the device's work alone, not the host's
    launches. One warm-up call first."""
    fn()
    torch.cuda.synchronize()
    pairs, enqueue = [], 0.0
    for _ in range(reps):
        torch.cuda._sleep(HOLD_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        enqueue = max(enqueue, (time.perf_counter() - t0) * 1e3)
        pairs.append((start, end))
        torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps, enqueue


def _rng_forms(n: int, dev):
    """Every call form the paths make of the RNG at ``n`` lanes, made from
    a seed: ``(label, wrapper name, kernel call, plain call, bytes,
    operations)``; bytes and operations are K-rng's for that call."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.ops import threefry as tf

    rng = np.random.default_rng(n)
    key = sampling.key(2**33 + 17, dev)
    keys = tf.keys_for_plain(key, n)
    data = torch.tensor(np.concatenate([rng.integers(-2**40, 2**40, n - 4),
                                        [-1, 2**31, 2**32 - 1, 2**32 + 3]]), device=dev)
    grid = keys.reshape(512, n // 512, 2)
    hashed = n * HASH_OPS
    forms = [
        ("fold batch x int", "threefry_fold", lambda: tf.threefry_fold(keys, 0xB5DF),
         lambda: tf.fold_in_plain(keys, 0xB5DF), n * 32, hashed),
        ("fold key x data", "threefry_fold", lambda: tf.threefry_fold(key, data),
         lambda: tf.fold_in_plain(key, data), 16 + n * 24, hashed),
        ("fold batch x batch", "threefry_fold", lambda: tf.threefry_fold(keys, data),
         lambda: tf.fold_in_plain(keys, data), n * 40, hashed),
        ("fold (A, B) keys x int", "threefry_fold", lambda: tf.threefry_fold(grid, 3),
         lambda: tf.fold_in_plain(grid, 3), n * 32, hashed),
        ("split", "threefry_split", lambda: tf.threefry_split(key, n),
         lambda: tf.keys_for_plain(key, n), 16 + n * 16, hashed),
    ]
    for lo, hi in ((-1.0 / 512.0, 1.0 / 512.0), (-0.25, 0.25), (0.0, 1.0)):
        forms.append((f"uniform [{lo:g}, {hi:g})", "threefry_uniform",
                      lambda lo=lo, hi=hi: tf.threefry_uniform(keys, 1, lo, hi),
                      lambda lo=lo, hi=hi: tf.uniforms_plain(keys, 1, lo, hi),
                      n * 20, n * (HASH_OPS + MAP_OPS)))
    for count in (2, 3):
        forms.append((f"uniform{count}", "threefry_uniform",
                      lambda c=count: tf.threefry_uniform(keys, c),
                      lambda c=count: tf.uniforms_plain(keys, c),
                      n * (16 + 4 * count), n * count * (HASH_OPS + MAP_OPS)))
    forms.append(("uniform3 of (A, B) keys", "threefry_uniform",
                  lambda: tf.threefry_uniform(grid, 3), lambda: tf.uniforms_plain(grid, 3),
                  n * 28, n * 3 * (HASH_OPS + MAP_OPS)))
    forms.append(("bits x3", "threefry_bits", lambda: tf.threefry_bits(keys, 3),
                  lambda: tf.random_bits_plain(keys, 3), n * 40, n * 3 * (HASH_OPS + 1)))
    for label, args in _draw_forms(key, keys, data, n).items():
        forms.append((label, "threefry_draw", lambda a=args: _drawn(tf.threefry_draw(*a)),
                      lambda a=args: _drawn(tf.draw_plain(*a)), *_draw_work(*args)))
    return forms


def _draw_forms(key, keys, data, n: int) -> dict:
    """The draw form's call forms on the paths, by label: ``(keys, data,
    tags, draws, key_out)``: the camera's jitter (one key x pixel ids,
    tag s; two draws at +-1/512), `sample_f`'s on a level of the
    surface path (a batch of trace keys, folds b and 3; r1 r2 and rr), a
    sphere light's from the estimate keys (one key x pixel ids, folds s,
    4, b, 2 and the light's; uniform2), and a chain materialised (the key
    written, no draw)."""
    from rpt_tpu_torch.ops import threefry as tf

    D = tf.Draw
    jitter = D((1,), 1, -1.0 / 512.0, 1.0 / 512.0), D((2,), 1, -1.0 / 512.0, 1.0 / 512.0)
    return {
        "draw camera (key x pixel ids; jitter)": (key, data, (5,), jitter, False),
        "draw sample_f (batch, chain of 2; r1 r2, rr)":
            (keys, None, (1, 3), (D((0xB5DF,), 2), D((0xF7E5,))), False),
        "draw light (key x pixel ids, chain of 5; uniform2)":
            (key, data, (5, 4, 1, 2, 0x1100), (D((0x5A1,), 2),), False),
        "draw key out (key x pixel ids, chain of 2)": (key, data, (5, 4), (), True),
    }


def _drawn(result) -> tuple:
    """A draw's outputs as one tuple: its floats, then its keys if any."""
    floats, out_keys = result
    return floats if out_keys is None else (*floats, out_keys)


def _draw_work(keys, data, tags, draws, key_out) -> tuple:
    """(bytes, int32 operations) of a draw over its lanes: each key row and
    data word read once, each float and key written once; a lane's hashes
    (its data fold, its chain, each draw's suffix and words) at `HASH_OPS`,
    each word's map at `MAP_OPS`."""
    n = data.shape[0] if data is not None else keys.shape[0]
    words = sum(d.count for d in draws)
    rows = 1 if keys.dim() == 1 else n
    n_bytes = 16 * rows + (8 * n if data is not None else 0) + 4 * n * words + 16 * n * key_out
    hashes = (data is not None) + len(tags) + sum(len(d.tags) + d.count for d in draws)
    return n_bytes, n * (hashes * HASH_OPS + words * MAP_OPS)


def _compare(got, ref):
    """(bit-equal, max abs difference) of a K-rng call's outputs against
    the plain version's: keys and words as integers, floats by their bits
    for equality and by value for the difference."""
    got, ref = (o if isinstance(o, tuple) else (o,) for o in (got, ref))
    pairs = list(zip(got, ref))
    if len(got) != len(ref) or any(a.shape != b.shape for a, b in pairs):
        return False, float("inf")
    equal = all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                            b.view(torch.int32) if b.is_floating_point() else b)
                for a, b in pairs)
    err = max((float((a.double() - b.double()).abs().max()) if a.numel() else 0.0)
              for a, b in pairs)
    return equal, err


def phase_rng():
    """K-rng against its plain version on the card at `RNG_SIZES`: every
    call form the paths make, bit for bit on every element (keys and words
    as integers, floats by their bits), each wrapper launching once a call.
    Each form is timed: device time of one call (`_device_ms`, warm), the
    same with its inputs out of L2 (`_cold_ms`), and the host's wall a call
    back to back (`_time_ms`, what a host-bound render pays), beside the
    plain version's device time and wall and the bound. Returns the
    numbers by ``(label, n)``."""
    from rpt_tpu_torch.ops import threefry as tf

    numbers = {}
    for n in RNG_SIZES:
        for label, name, kernel, plain, n_bytes, n_ops in _rng_forms(n, "cuda"):
            before = _launched(name)
            got = kernel()
            launched = _launched(name) - before
            equal, err = _compare(got, plain())
            ms, enqueue = _device_ms(kernel)
            plain_ms, plain_enqueue = _device_ms(plain)
            cold = _cold_ms(kernel, 5)
            host = _time_ms(kernel, 20)
            plain_host = _time_ms(plain, 5)
            bound_ms, bound_by = _bound(n_bytes, n_ops, INT32_OPS_PER_S)
            print(f"[K-rng] {label}, {n} lanes: bit-equal to the plain version {equal} (max "
                  f"abs difference {err:g}), {launched} launch; device {ms * 1e3:.2f} us a call "
                  f"({cold * 1e3:.2f} us with its inputs out of L2), host wall {host * 1e3:.2f} "
                  f"us a call back to back; plain version device {plain_ms * 1e3:.1f} us, wall "
                  f"{plain_host * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}: "
                  f"{n_bytes} bytes, {n_ops} int32 ops), {ms / bound_ms:.1f}x; enqueue "
                  f"{enqueue:.3f} / {plain_enqueue:.3f} ms under the {HOLD_CYCLES} cycle hold")
            if not equal or launched != 1:
                raise RuntimeError(f"K-rng {label} at {n} lanes: bit-equal {equal}, "
                                   f"{launched} launches")
            numbers[(label, n)] = {"name": name, "max_abs_err": err, "ms": ms, "cold_ms": cold,
                                   "host_ms": host, "plain_ms": plain_ms,
                                   "plain_host_ms": plain_host, "bound_ms": bound_ms,
                                   "bound_by": bound_by}
    return numbers


def _rng_entry(name: str, label: str, replaces: str, numbers: dict, side=()) -> dict:
    """A K-rng kernel entry: ``label``'s numbers at 262,144 lanes, at 2^19
    as ``n524288_*`` side fields, and the forms in ``side`` (prefix,
    label) as side fields; launches and ``max_abs_err`` are filled in by
    `_rng_entries`."""
    small, large = RNG_SIZES
    keys = ("ms", "cold_ms", "host_ms", "plain_ms", "plain_host_ms", "bound_ms")
    entry = {"name": name, "route": "cuda", "source": "rpt_tpu_torch/csrc/threefry.cu",
             "replaces": replaces, "form": label, "lanes": small,
             **{k: numbers[(label, small)][k] for k in (*keys, "bound_by")},
             "library_ms": None,
             **{f"n{large}_{k}": numbers[(label, large)][k] for k in keys}}
    for prefix, other in side:
        entry.update({f"{prefix}_{k}": numbers[(other, small)][k] for k in keys})
    return entry


def _rng_entries(numbers: dict) -> list:
    """The `kernels` line's K-rng entries: fold, split, uniform and draw,
    each with its launches summed over the paths the smoke drove and by
    path; ``random_bits`` rides as side fields of uniform, and the draw
    form's other call forms as side fields of its entry. Since the draw
    form took the paths' draws, uniform is held to its plain version here
    but no path launches it; fold, split and draw must each have been
    launched by some path."""
    draw_side = [(f"form{i}", label) for i, label in enumerate(
        ("draw camera (key x pixel ids; jitter)",
         "draw light (key x pixel ids, chain of 5; uniform2)",
         "draw key out (key x pixel ids, chain of 2)"), 1)]
    entries = [
        _rng_entry("threefry_fold", "fold batch x int", "rpt_tpu/sampling.py:36", numbers,
                   (("key_x_data", "fold key x data"),)),
        _rng_entry("threefry_split", "split", "rpt_tpu/sampling.py:31", numbers),
        _rng_entry("threefry_uniform", "uniform [0, 1)", "rpt_tpu/sampling.py:41", numbers,
                   (("uniform2", "uniform2"), ("uniform3", "uniform3"), ("bits", "bits x3"))),
        _rng_entry("threefry_draw", "draw sample_f (batch, chain of 2; r1 r2, rr)",
                   "rpt_tpu/sampling.py:41", numbers, draw_side),
    ]
    entries[-1].update({f"{prefix}_label": label for prefix, label in draw_side})
    for entry in entries:
        names = {entry["name"]} | ({"threefry_bits"} if entry["name"] == "threefry_uniform"
                                   else set())
        errs = [v["max_abs_err"] for v in numbers.values() if v["name"] in names]
        by_path = {path: counts[entry["name"]] for path, counts in RNG_LAUNCHES.items()}
        entry.update(max_abs_err=max(errs), launches=sum(by_path.values()),
                     launches_by_path=by_path)
        if entry["launches"] <= 0 and entry["name"] != "threefry_uniform":
            raise RuntimeError(f"no path launched {entry['name']}")
    return entries


def _rng_counts() -> dict:
    return {name: _launched(name) for name in RNG_WRAPPERS}


def _read_rng(path: str, shoots: bool = False) -> dict:
    """Record the K-rng launches of ``path`` since `_zero_counts` (adding to
    what an earlier run of the same path recorded) and fail where the path
    drew no float through the draw form or, for a photon shoot, split no
    chunk's keys."""
    counts = _rng_counts()
    need = ("threefry_draw",) + (("threefry_split",) if shoots else ())
    missing = [name for name in need if counts[name] <= 0]
    if missing:
        raise RuntimeError(f"the {path} path never launched {missing}: {counts}")
    seen = RNG_LAUNCHES.setdefault(path, dict.fromkeys(RNG_WRAPPERS, 0))
    for name, n in counts.items():
        seen[name] += n
    return counts


# K-rng's wrappers in `ops/threefry.py`, through which `rpt_tpu_torch.
# sampling` (and its `KeyPath`) makes every draw, by name, and their plain
# versions: the unfused int64 torch chains, what the renders gave before
# K-rng (the draw form's is `draw_plain`, its fold chain then uniform).
def _plain_rng_functions():
    from rpt_tpu_torch.ops import threefry as tf

    return {"threefry_fold": tf.fold_in_plain, "threefry_split": tf.keys_for_plain,
            "threefry_uniform": tf.uniforms_plain, "threefry_bits": tf.random_bits_plain,
            "threefry_draw": tf.draw_plain}


def phase_rng_renders(ex):
    """The 32^2 point-beam golden render and the Cornell golden render
    (48x48, 24 spp) twice: as shipped (K-rng) and with K-rng's wrappers
    patched here to their plain versions (int64 torch ops; the draw form
    to its unfused composition); the radiance of each must be bit-equal,
    and only the first may launch K-rng."""
    import torch_cornell
    from rpt_tpu_torch.ops import threefry as tf

    def renders():
        pb = ex.renderer("cuda", size=32, bounce=6, sample=2, photons=4000, seed=42)
        pb.photon_point_query_beam_render(4000)
        cornell = torch_cornell.renderer("cuda")
        cornell.render()
        return {"point-beam 32^2": pb._last_buffer.raw(), "Cornell": cornell._last_buffer.raw()}

    _zero_counts()
    shipped = renders()
    shipped_counts = _rng_counts()
    saved = {name: getattr(tf, name) for name in _plain_rng_functions()}
    _zero_counts()
    try:
        for name, fn in _plain_rng_functions().items():
            setattr(tf, name, fn)
        plain = renders()
    finally:
        for name, fn in saved.items():
            setattr(tf, name, fn)
    plain_counts = _rng_counts()
    ok = shipped_counts["threefry_draw"] > 0 and not sum(plain_counts.values())
    for label, raw in shipped.items():
        same = raw.shape == plain[label].shape and np.array_equal(raw, plain[label])
        differ = int((raw != plain[label]).sum()) if raw.shape == plain[label].shape else -1
        ok = ok and same
        print(f"[K-rng] {label} render with K-rng and with the plain RNG: bit-equal {same} "
              f"({differ} of {raw.size} values differ), radiance mean {raw.mean():.6f}")
    print(f"[K-rng] launches of the two renders: K-rng {shipped_counts}, plain {plain_counts}")
    if not ok:
        raise RuntimeError("the renders with K-rng differ from those with the plain RNG")


def _cull_work(o, d, th, table, chunk: int = 2048):
    """From the cull's plain version (`tile_keep_plain`): the (ray, tile)
    tests K-sweep's cull does (a tile stops at the first ray of its block
    that keeps it) and the tiles kept per block of RAYS rays."""
    from rpt_tpu_torch.ops.sphere_sweep import RAYS, tile_keep_plain

    tests, kept = 0, []
    for s in range(0, o.shape[0], chunk):
        keep = tile_keep_plain(o[s : s + chunk], d[s : s + chunk], th[s : s + chunk], table)
        live = torch.full((-(-keep.shape[0] // RAYS),), RAYS, device=o.device)
        live[-1] = keep.shape[0] - RAYS * (live.shape[0] - 1)
        keep = torch.cat([keep, keep.new_zeros((live.shape[0] * RAYS - keep.shape[0],
                                                 keep.shape[1]))])
        keep = keep.reshape(-1, RAYS, keep.shape[1])
        any_ = keep.any(dim=1)
        first = torch.argmax(keep.to(torch.uint8), dim=1)
        tests += int(torch.where(any_, first + 1, live[:, None]).sum())
        kept.append(any_.sum(dim=1))
    return tests, torch.cat(kept)


def _sweep_case(label, o, d, th, table, ext, col, phase_const):
    """K-sweep on one case against its plain version: the estimate (rtol
    `SWEEP_RTOL`), bit equality across two calls, the pierced pairs of
    every ray, and the work the cull leaves. Returns the case's numbers."""
    from rpt_tpu_torch.ops.sphere_sweep import (
        RAYS, TILE, pierced_count, pierced_count_plain, sphere_sweep, sphere_sweep_plain,
    )

    kw = dict(n_spheres=table.n_spheres, phase_const=phase_const)
    out = sphere_sweep(o, d, th, table, ext, col, **kw)
    again = sphere_sweep(o, d, th, table, ext, col, **kw)
    ref, plain_ms = _events_ms(lambda: sphere_sweep_plain(o, d, th, table.spheres_t, ext, col,
                                                          **kw))
    ms = _time_ms(lambda: sphere_sweep(o, d, th, table, ext, col, **kw), 10)
    err = float((out - ref).abs().max())
    ok = bool(torch.allclose(out, ref, rtol=SWEEP_RTOL, atol=1e-6 * float(ref.abs().max())))
    bitwise = bool(torch.equal(out, again))
    count, kept = pierced_count(o, d, th, table)
    count_ref = pierced_count_plain(o, d, th, table.spheres_t, table.n_spheres)
    same = float((count.long() == count_ref).float().mean())
    tile_tests, kept_plain = _cull_work(o, d, th, table)
    n, p = o.shape[0], table.n_spheres
    pair_tests = int(kept.sum()) * TILE * RAYS
    pierced = int(count_ref.sum())
    print(f"[K-sweep] {label}: {n} rays x {p} spheres, tile {TILE}: tiles kept "
          f"{int(kept.sum())} of {kept.numel() * table.n_tiles} (block, tile) pairs (plain cull "
          f"{int(kept_plain.sum())}); pair tests {pair_tests} = {pair_tests / (n * p):.5f} of "
          f"dense {n * p}; tile tests {tile_tests}; pierced pairs {pierced} "
          f"({pierced / max(n, 1):.1f} per ray); rays with the plain pierced count {same:.6f}; "
          f"max abs err {err:.3e} ok {ok}; bit-identical across calls {bitwise}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    if not (ok and bitwise and same == 1.0):
        raise RuntimeError(f"K-sweep fails on {label}: agrees {ok}, bit-identical {bitwise}, "
                           f"pierced counts equal on {same:.6f} of rays")
    # the function's own work is weighing the pierced pairs; the pair and
    # tile tests are what this design spends to find them
    return {"err": err, "ms": ms, "plain_ms": plain_ms,
            "bytes": _nbytes(o, d, th, table.records, table.bounds, out),
            "ops": pierced * PIERCED_OPS,
            "design_ops": pair_tests * PAIR_OPS + tile_tests * TILE_TEST_OPS + pierced * PIERCED_OPS,
            "dense_ops": n * p * PAIR_OPS + pierced * PIERCED_OPS}


def _far_small_case(g, n: int, clusters: int, copies: int):
    """Rays from about the lampshade camera (z = -800, ~1,400 units from
    the far wall) grazing spheres of radius 0.5 in tight clusters, where
    float32 cancellation in oc2 - dd*dd exceeds r^2: each ray passes 0.3-1.0
    units from a sphere centre, half of them stopping one unit past it."""
    dev = g.device
    hub = torch.rand((clusters, 3), device=dev, generator=g) * 556
    pos = (hub.repeat_interleave(copies, dim=0)
           + torch.randn((clusters * copies, 3), device=dev, generator=g) * 0.5)
    target = pos[torch.randint(0, pos.shape[0], (n,), device=dev, generator=g)]
    o = (torch.tensor([278.0, 273.0, -800.0], device=dev)
         + torch.randn((n, 3), device=dev, generator=g) * 20)
    across = torch.nn.functional.normalize(
        torch.cross(target - o, torch.randn((n, 3), device=dev, generator=g), dim=1), dim=1)
    aim = target + across * (0.3 + 0.7 * torch.rand((n, 1), device=dev, generator=g))
    d = torch.nn.functional.normalize(aim - o, dim=1)
    th = torch.where(torch.rand(n, device=dev, generator=g) < 0.5,
                     (target - o).norm(dim=1) + 1.0, torch.full((n,), float("inf"), device=dev))
    return pos, o, d, th


def phase_sweep(r, ex):
    """K-sweep on the lampshade's sample-0 wavefront (the render's own
    table), on a ragged random case and on a far-small-sphere case; the
    JSON entry carries the sample-0 numbers."""
    from rpt_tpu_torch.ops.sphere_sweep import build_sphere_table, pack_spheres_transposed

    scene, pmap = r.compiled, r.photon_map
    medium = scene.media[0]
    ray, _, hit = _sample0(r)
    ext = float(medium.extinction(ray.origin[0:1]).item())
    phase = float(medium.phase_const)
    o, d = ray.origin.to_array().contiguous(), ray.dir.to_array().contiguous()
    th = torch.where(hit.valid, hit.time, float("inf"))
    one = torch.ones(3, device="cuda")
    main = _sweep_case("lampshade sample 0", o, d, th, pmap.spheres, ext, one, phase)
    bound_ms, bound_by = _bound(main["bytes"], main["ops"])
    design_ms = _bound(main["bytes"], main["design_ops"])[0]
    dense_ms = _bound(main["bytes"], main["dense_ops"])[0]
    print(f"[K-sweep] lampshade sample 0: bound {bound_ms * 1e3:.1f} us ({bound_by}: "
          f"{main['bytes']} bytes, pierced pairs {main['ops'] / PIERCED_OPS:.0f} x "
          f"{PIERCED_OPS} ops); the pair and tile tests this design does {design_ms:.3f} ms of "
          f"operations, the dense sweep's {dense_ms:.3f} ms; kernel {main['ms']:.3f} ms = "
          f"{main['ms'] / bound_ms:.1f}x its bound, {main['ms'] / design_ms:.2f}x its "
          f"design's work")

    # ragged synthetic case: neither N nor P a multiple of a block
    g = torch.Generator(device="cuda").manual_seed(0)
    n2, p2 = 1000, 5003
    o2 = torch.rand((n2, 3), device="cuda", generator=g) * 100
    d2 = torch.nn.functional.normalize(torch.randn((n2, 3), device="cuda", generator=g), dim=1)
    th2 = torch.where(torch.rand(n2, device="cuda", generator=g) < 0.5,
                      torch.rand(n2, device="cuda", generator=g) * 180 + 20,
                      torch.full((n2,), float("inf"), device="cuda"))
    sph = pack_spheres_transposed(torch.rand((p2, 3), device="cuda", generator=g) * 100,
                                  torch.rand(p2, device="cuda", generator=g) * 5 + 5,
                                  torch.randn((p2, 3), device="cuda", generator=g),
                                  torch.rand((p2, 3), device="cuda", generator=g))
    col = torch.full((3,), 0.5, device="cuda")
    ragged = _sweep_case(f"ragged {n2} x {p2}", o2, d2, th2, build_sphere_table(sph, p2), 1e-3,
                         col, phase)

    pos, o3, d3, th3 = _far_small_case(g, 16384, 2048, 128)
    p3 = pos.shape[0]
    sph3 = pack_spheres_transposed(pos, torch.full((p3,), 0.5, device="cuda"),
                                   torch.zeros_like(pos), torch.rand((p3, 3), device="cuda",
                                                                     generator=g))
    far = _sweep_case("far small spheres", o3, d3, th3, build_sphere_table(sph3, p3), ext, one,
                      phase)
    return {"name": "sphere_sweep", "route": "cuda",
            "source": "rpt_tpu_torch/csrc/sphere_sweep.cu",
            "replaces": "rpt_tpu/ops/sphere_sweep.py:111",
            "max_abs_err": max(main["err"], ragged["err"], far["err"]),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _gather_bound(q, k, idx, valid):
    """K-knn's bound on one gather: ``(bound_ms, bound_by, rows)``. Bytes:
    the ``rows`` distinct points among its answers read once (16-byte
    rows), the queries read once, indices and distances written once; the
    rest of the cloud, and the codes that this design's searches read, are
    not the function's. Operations: at least 8 for each of a query's k
    distances."""
    rows = int(torch.unique(idx[valid]).numel())
    bound_ms, bound_by = _bound(rows * 16 + _nbytes(q) + q.shape[0] * k * 8, q.shape[0] * k * 8)
    return bound_ms, bound_by, rows


def _knn_compare(grid, q, k, d2p=None):
    """K-knn against brute force on queries ``q`` (``d2p``: `knn_plain`'s
    d^2 for them, when already computed): the share of rows whose sorted
    d^2 agree (rtol 1e-6), the share bit-equal, the max abs d^2 error, and
    whether every returned index is a distinct point lying at its returned
    d^2 (recomputed in the kernel's operation order)."""
    from rpt_tpu_torch.accel.knn import knn_plain, knn_query

    idx, d2, valid = knn_query(grid, q, k)
    if d2p is None:
        _, d2p, _ = knn_plain(grid.points, q, k)
    p = grid.points[idx]
    dx, dy, dz = (p[..., i] - q[:, None, i] for i in range(3))
    at = torch.where(valid, dx * dx + dy * dy + dz * dz, float("inf"))
    tagged = torch.where(valid, idx, -1 - torch.arange(k, device=idx.device))
    ranked = torch.sort(tagged, dim=1).values
    idx_ok = bool(torch.isclose(at, d2, rtol=1e-6, atol=0.0).all()
                  and (ranked[:, 1:] != ranked[:, :-1]).all())
    same = torch.isclose(d2, d2p, rtol=1e-6, atol=0.0).all(dim=1).float().mean().item()
    exact = (d2 == d2p).all(dim=1).float().mean().item()
    fin = torch.isfinite(d2p)
    err = float((d2 - d2p)[fin].abs().max()) if bool(fin.any()) else 0.0
    return same, exact, err, idx_ok


def _quantiles(x):
    """'median a, p99 b, max c' of a tensor of counts."""
    x = x.float().flatten()
    return (f"median {float(x.median()):.0f}, p99 {float(torch.quantile(x, 0.99)):.0f}, "
            f"max {float(x.max()):.0f}")


def _top_share(x, share: float = 0.001) -> float:
    """The part of ``x``'s sum that its largest ``share`` of entries hold."""
    x = x.double().flatten()
    top = torch.topk(x, max(1, int(share * x.numel()))).values
    return float(top.sum() / x.sum().clamp(min=1.0))


def _radius_pass(volume, k):
    """K-knn's self-query over the volume cloud: one timed launch for all
    points against its bound; the k-th d^2 held to `knn_plain` on 4096
    random points and the 1024 of largest radius (bit-equal on >= 99.9% of
    rows, rtol 1e-6 on all); the counting variant's distributions, and what
    a walk of Chebyshev rings over a uniform grid sized from the bounding
    box (about two cells a point, the earlier design) would step for the
    same radii."""
    from rpt_tpu_torch.accel.knn import knn_plain, knn_radius, knn_radius_counts

    g = torch.Generator(device="cuda").manual_seed(2)
    d2 = knn_radius(volume, k)
    ms = _time_ms(lambda: knn_radius(volume, k), 5)
    rows = torch.cat([torch.randint(0, volume.n, (4096,), device="cuda", generator=g),
                      torch.topk(d2, min(1024, volume.n)).indices])
    (_, ref, valid), plain_ms = _events_ms(lambda: knn_plain(volume.points, volume.points[rows],
                                                             k))
    ref = torch.where(valid, ref, 0.0).max(dim=1).values
    exact = float((d2[rows] == ref).float().mean())
    close = bool(torch.isclose(d2[rows], ref, rtol=1e-6, atol=0.0).all())
    # every point and its cell code read once, one f32 a point written; at
    # least 8 operations for each of a point's k distances
    bound_ms, bound_by = _bound(_nbytes(volume.rows, volume.codes, d2), volume.n * k * 8)
    print(f"[K-knn] radius pass: {volume.n} volume photons, k={k}, a cube of side "
          f"{volume.h * 65536:.1f}, 1 launch: kernel {ms:.3f} ms, bound "
          f"{bound_ms * 1e3:.1f} us ({bound_by}), {ms / bound_ms:.1f}x; k-th d^2 bit-equal to "
          f"brute force on {exact:.5f} of {rows.numel()} rows (4096 random + the 1024 of "
          f"largest radius), all within rtol 1e-6: {close}; plain {plain_ms:.3f} ms for those "
          f"rows")
    if exact < KNN_ROW_AGREEMENT or not close:
        raise RuntimeError(f"K-knn's radius pass agrees with brute force on {exact:.5f} of rows, "
                           f"all close {close}")
    c = knn_radius_counts(volume, k)
    print(f"[K-knn] radius pass counts: candidates a point {_quantiles(c[:, 2])} (the heaviest "
          f"0.1% of points test {_top_share(c[:, 2]):.4f} of all candidates); cells "
          f"{_quantiles(c[:, 1])}; points a unit mean {float(c[:, 3].float().mean()):.1f}; "
          f"points whose unit's certificate failed {float((c[:, 0] > 1).float().mean()):.6f}, "
          f"levels {_quantiles(c[:, 0])}")
    lo, hi = volume.points.min(0).values, volume.points.max(0).values
    h_box = float(((hi - lo).clamp(min=1e-6).prod() / (2 * volume.n)) ** (1.0 / 3.0))
    rings = torch.floor(torch.sqrt(d2) / h_box) + 1
    columns = (rings + 1) * (2 * rings + 1) * (2 * rings + 3) / 3
    chunk_max = torch.stack([columns[s : s + (1 << 18)].max()
                             for s in range(0, volume.n, 1 << 18)])
    print(f"[K-knn] a ring walk over a uniform grid of cell {h_box:.3f} (two cells a point of "
          f"the bounding box) would take, from the same radii: rings {_quantiles(rings)}; "
          f"columns {_quantiles(columns)}; the heaviest 0.1% of points {_top_share(columns):.4f} "
          f"of all column steps; the slowest point of each chunk of 2^18 "
          f"{[int(v) for v in chunk_max.tolist()]} columns against a mean of "
          f"{float(columns.mean()):.0f}")
    return {"radius_ms": ms, "radius_bound_ms": bound_ms, "radius_plain_ms_5120_rows": plain_ms}


def phase_knn(r):
    from rpt_tpu_torch.accel.knn import build_grid, knn_plain, knn_query, knn_query_counts
    from rpt_tpu_torch.integrators.photon import RADIUS_K

    pmap = r.photon_map
    g = torch.Generator(device="cuda").manual_seed(1)
    surface = pmap.surface_grid
    volume = build_grid(pmap.spheres.spheres_t[0:3, :pmap.spheres.n_spheres].T.contiguous())
    radius = _radius_pass(volume, RADIUS_K)
    # the camera pass's queries: sample 0's surface gather points, as
    # surface_estimate forms them (the origin of space, outside the grid,
    # for a ray that hits nothing)
    ray, _, hit = _sample0(r)
    pos = torch.where(hit.valid[:, None], ray.at(hit.time).to_array(), 0.0).contiguous()
    cases = (
        ("surface cloud, 4096 sampled points", surface,
         surface.points[torch.randint(0, surface.n, (4096,), device="cuda", generator=g)],
         r.gather_size_),
        ("volume cloud, 4096 sampled points", volume,
         volume.points[torch.randint(0, volume.n, (4096,), device="cuda", generator=g)],
         RADIUS_K),
        (f"camera pass, {pos.shape[0]} hit points ({int((~hit.valid).sum())} misses)",
         surface, pos, r.gather_size_),
    )
    worst, err, idx_ok = 1.0, 0.0, True
    for name, grid, q, k in cases:
        same, exact, e, ok = _knn_compare(grid, q, k)
        worst, err, idx_ok = min(worst, same), max(err, e), idx_ok and ok
        ms = _time_ms(lambda: knn_query(grid, q, k), 5)
        plain_ms = _time_ms(lambda: knn_plain(grid.points, q, k), 1)
        c = knn_query_counts(grid, q, k)
        print(f"[K-knn] {name} x {grid.n} points, k={k}: rows agreeing "
              f"{same:.5f} (bit-equal {exact:.5f}), max abs err {e:.3e}, indices consistent "
              f"{ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; counts: levels scanned "
              f"{_quantiles(c[:, 0])}; cells {_quantiles(c[:, 1])}; candidates "
              f"{_quantiles(c[:, 2])} (heaviest 0.1%: {_top_share(c[:, 2]):.4f} of all); start "
              f"level {_quantiles(c[:, 3])}")
    if worst < KNN_ROW_AGREEMENT or not idx_ok:
        raise RuntimeError(f"K-knn agrees with brute force on only {worst:.5f} of rows, "
                           f"indices consistent {idx_ok}")
    # the reported times are the camera pass's (the last case), with its
    # data out of L2 as between the render's launches, and warm
    idx, _, valid = knn_query(grid, q, k)
    bound_ms, bound_by, rows = _gather_bound(q, k, idx, valid)
    cold = _cold_ms(lambda: knn_query(grid, q, k), 5)
    print(f"[K-knn] camera pass: kernel {cold:.3f} ms with its data out of L2 ({ms:.3f} warm); "
          f"bound {bound_ms * 1e3:.2f} us ({bound_by}; {rows} distinct points answer), "
          f"{cold / bound_ms:.1f}x its bound")
    return {"name": "knn_query", "route": "cuda", "source": "rpt_tpu_torch/csrc/knn.cu",
            "replaces": "rpt_tpu/accel/grid.py:605", "max_abs_err": err, "ms": cold,
            "warm_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, **radius}


def phase_golden(ex):
    """tests/test_golden.py:78-89,116-118 settings; `_check_img`'s mean
    tolerance 0.02 and p99 tolerance 0.2 of the golden's mean, the latter
    floored at one u8 level: the golden's mean is ~5 levels, so 0.2 of it
    is under one quantization step, and the JAX package that made the
    golden truncates k-NN where the port is exact (tests/test_torch_photon.py
    says more; the floor is kept by decision and applies to this golden
    only, PERF.md). The line also prints p99 / mean for the unfloored
    limit."""
    r = ex.renderer("cuda", size=32, bounce=6, sample=2, photons=4000, seed=42)
    img = r.photon_point_query_beam_render(4000).astype(np.float64)
    ref = np.load(GOLDEN).astype(np.float64)
    diff = np.abs(img - ref)
    scale = max(ref.mean(), 1e-6)
    mean_rel = diff.mean() / scale
    p99 = np.percentile(diff, 99)
    ok = mean_rel < 0.02 and p99 <= max(0.2 * scale, 1.0)
    print(f"[golden] 32x32 4000 photons 2 spp seed 42: mean |diff|/mean {mean_rel:.4f} "
          f"(< 0.02), p99 |diff| {p99:.1f} levels (<= max(0.2*mean, 1) = "
          f"{max(0.2 * scale, 1.0):.3f}; p99/mean {p99 / scale:.4f}, unfloored limit 0.2), "
          f"values differing {int((diff > 0).sum())} of {diff.size}; ok {ok}")
    if not ok:
        raise RuntimeError("golden check failed")


def phase_dragon():
    """The path tracer's main path at bench.py's full size: one untimed
    warm-up sample, then ``render()`` with the launch counts zeroed just
    before it and read just after."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_dragon as dr
    from rpt_tpu_torch import Buffer
    from rpt_tpu_torch.renderer import RayCounter

    t0 = time.perf_counter()
    scene = dr.build_scene()
    t_mesh = time.perf_counter() - t0
    r = dr.renderer("cuda", scene=scene)
    t0 = time.perf_counter()
    compiled = r.compiled
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    host = compiled.build_seconds
    bvh = compiled.tables["bvh"]
    print(f"[dragon] scene: {compiled.n_tris} triangles (mesh {t_mesh:.2f} s), SAH build "
          f"{host['sah']:.2f} s, pack {host['pack']:.2f} s, compile {t_compile:.2f} s; "
          f"{bvh.nodes.shape[0]} node rows, {bvh.leaves.shape[0]} leaf rows, stack bound "
          f"{bvh.stack_depth}")

    t0 = time.perf_counter()
    r.sample(1, Buffer(r.width_, r.height_, r.filter_))
    warm = time.perf_counter() - t0
    r._sample_index, r.ray_counter = 0, RayCounter()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: _launched(name) for name in ("bvh_closest_hit", "bvh_any_hit")}
    rng = _read_rng("dragon")
    prims = _read_prim("dragon")
    segs = r.ray_counter.segments
    raw = r._last_buffer.raw()
    finite = bool(np.isfinite(raw).all())
    print(f"[dragon] {r.width_}x{r.height_} {r.num_samples_} spp {r.max_bounces_} bounces: "
          f"wall {wall:.3f} s (warm-up sample {warm:.3f} s), {segs} ray segments, "
          f"{segs / wall / 1e6:.3f} Mrays/s; image mean {img.mean():.4f} (radiance "
          f"{raw.mean():.5f}), finite {finite}; launches {launches}, K-rng {rng}, K-prim "
          f"{prims} (the plane)")
    if not finite or img.shape != (r.height_, r.width_, 3) or img.mean() <= 0:
        raise RuntimeError("dragon render is not a finite, non-black image of the right shape")
    for name, n in {**launches, **prims}.items():
        if n <= 0:
            raise RuntimeError(f"the dragon render never launched {name}")
    return r, launches


def _recording(attr: str, names, run) -> dict:
    """The calls ``run()`` makes to the wrappers ``names`` that
    `rpt_tpu_torch.intersect` calls through its module ``attr``:
    ``{name: [(args, kwargs), ...]}``, in call order."""
    from types import SimpleNamespace

    from rpt_tpu_torch import intersect

    wrappers = getattr(intersect, attr)
    calls = {name: [] for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return getattr(wrappers, name)(*args, **kwargs)
        return call

    setattr(intersect, attr, SimpleNamespace(**{name: recorder(name) for name in names}))
    try:
        run()
    finally:
        setattr(intersect, attr, wrappers)
    return calls


def _capture_calls(r, attr: str, names) -> dict:
    """Sample 0 of a path-traced render, traced once more with the wrappers
    ``names`` that `rpt_tpu_torch.intersect` calls through its module
    ``attr`` recording their arguments (`_recording`), a chunk's levels,
    then the next chunk's."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.renderer import _path_pass

    return _recording(attr, names, lambda: _path_pass(
        r.compiled, r.camera, r.width_, r.height_, sampling.key(r.seed_, r.device), 0, 1,
        r.max_bounces_, r.media_max_depth_))


def _capture_wavefronts(r):
    """The calls of K1 (camera, then bounce levels) and of K2 (batched
    shadows per level) in sample 0 of the dragon, in order."""
    return _capture_calls(r, "kernels", ("bvh_closest_hit", "bvh_any_hit"))


def _events_ms(fn):
    """(result, milliseconds) of one call of ``fn`` on the card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _traverse_bound(args, kwargs, outs):
    """K1/K2's bound on one wavefront: the rays and their per-lane inputs,
    the node and leaf rows (each read once) and the results moved; at
    least one box test (~20 operations) per lane."""
    bvh, lanes = args[0], args[1].shape[0]
    inputs = [a for a in (*args[1:], *kwargs.values()) if isinstance(a, torch.Tensor)]
    return _bound(_nbytes(*inputs, bvh.nodes, bvh.leaves, *outs), lanes * 20)


def _traverse_counts(label, any_hit, args, kwargs):
    """The counting variant of K1 or K2 on one wavefront: the lanes that
    enter, steps and leaf slots per entering lane, and the live-lane share
    (the steps the rays took over 32 x the longest ray of each warp, what
    warps in lockstep spend): of the kernel's warps, which hold the packed
    entering lanes where the call is gated, and of warps of 32 consecutive
    lanes of the wavefront, as without packing."""
    from rpt_tpu_torch.ops.bvh_traverse import traverse_counts

    counts, live_share = traverse_counts(any_hit, *args, **kwargs)
    steps, slots = counts[:, 0], counts[:, 1]
    entered = steps > 0
    warps = torch.nn.functional.pad(steps, (0, (-steps.numel()) % 32)).reshape(-1, 32)
    lane_share = float(warps.sum() / (32 * warps.max(dim=1).values.sum()).clamp(min=1))
    print(f"[{'K2' if any_hit else 'K1'}] {label} counts: {int(entered.sum())} of "
          f"{steps.numel()} lanes enter; steps a ray {_quantiles(steps[entered])} (mean "
          f"{float(steps[entered].float().mean()):.1f}); leaf slots {_quantiles(slots[entered])} "
          f"(mean {float(slots[entered].float().mean()):.1f}); live-lane share of the kernel's "
          f"warps {live_share:.4f}, of warps in lane order {lane_share:.4f}")


def _k1_case(label, args, kwargs):
    """K1 against its plain version on one captured wavefront (its line
    and its counts printed): ``(numbers, share, attrs_ok)``, where
    ``share`` is the lanes whose triangle agrees and ``attrs_ok`` says
    whether t, u, v, w agree where it does (`HIT_RTOL`, `BARY_ATOL`)."""
    from rpt_tpu_torch.ops.bvh_traverse import bvh_closest_hit, bvh_closest_hit_plain

    got = bvh_closest_hit(*args, **kwargs)
    ref, plain_ms = _events_ms(lambda: bvh_closest_hit_plain(*args, **kwargs))
    ms = _time_ms(lambda: bvh_closest_hit(*args, **kwargs), 5)
    same = got[1] == ref[1]
    share = float(same.float().mean())
    # t on every lane of an equal triangle (best_time where none is
    # hit); u, v, w on the lanes that hit
    t_ok = bool(torch.isclose(got[0][same], ref[0][same], rtol=HIT_RTOL, atol=0.0).all())
    hit = same & (ref[1] >= 0)
    errs = {}
    for name, a, b in zip("tuvw", got[0:1] + got[2:], ref[0:1] + ref[2:]):
        errs[name] = float((a[hit] - b[hit]).abs().max()) if bool(hit.any()) else 0.0
    uvw_ok = all(bool(torch.isclose(a[hit], b[hit], rtol=HIT_RTOL, atol=BARY_ATOL).all())
                 for a, b in zip(got[2:], ref[2:]))
    print(f"[K1] {label} wavefront, {same.numel()} lanes "
          f"({float((ref[1] >= 0).float().mean()):.4f} hit the mesh): tri equal on "
          f"{share:.6f} ({int((~same).sum())} lanes differ); where tri agrees max abs err "
          f"t {errs['t']:.3e} u {errs['u']:.3e} v {errs['v']:.3e} w {errs['w']:.3e}, "
          f"t ok {t_ok}, u/v/w ok {uvw_ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    _traverse_counts(f"{label} wavefront", False, args, kwargs)
    bound_ms, bound_by = _traverse_bound(args, kwargs, got)
    numbers = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": max(errs.values())}
    return numbers, share, t_ok and uvw_ok


def _k2_case(label, args, kwargs, t_min: float):
    """K2 against its plain version on one captured shadow wavefront (its
    line and its counts printed): ``(numbers, share)``."""
    from rpt_tpu_torch.ops.bvh_traverse import bvh_any_hit, bvh_any_hit_plain

    got = bvh_any_hit(*args, **kwargs)
    ref, plain_ms = _events_ms(lambda: bvh_any_hit_plain(*args, **kwargs))
    ms = _time_ms(lambda: bvh_any_hit(*args, **kwargs), 5)
    # as `intersect.bvh_any_hit` passes them
    limit = args[4]
    active = args[5] if len(args) > 5 else kwargs.get("active")
    gated = limit <= t_min
    if active is not None:
        gated = gated | ~active
    share = float((got == ref).float().mean())
    print(f"[K2] {label}, {got.numel()} lanes "
          f"({int(gated.sum())} gated off: limit <= t_min or inactive; "
          f"{float(ref.float().mean()):.4f} occluded): flag equal on {share:.6f} "
          f"({int((got != ref).sum())} lanes differ); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms")
    _traverse_counts(label, True, args, kwargs)
    bound_ms, bound_by = _traverse_bound(args, kwargs, (got,))
    numbers = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": float((got.float() - ref.float()).abs().max())}
    return numbers, share


def _check_traversal(worst: float, attrs_ok: bool, where: str):
    if worst < TRAVERSE_AGREEMENT:
        raise RuntimeError(f"K1/K2 agree with their plain versions on only {worst:.6f} "
                           f"of lanes (< {TRAVERSE_AGREEMENT}) on {where}")
    if not attrs_ok:
        raise RuntimeError(f"K1's t, u, v or w disagree with its plain version where the "
                           f"triangle agrees on {where}")


def phase_traverse(r):
    """K1 on sample 0's camera and level-1 bounce wavefronts, K2 on its
    level-0 and level-1 batched shadow wavefronts (-1 limits included),
    each against its plain version on the card. Where K1's triangle agrees,
    its t, u, v, w must too (`HIT_RTOL`, `BARY_ATOL`). The JSON entries
    carry the camera (K1) and level-1 (K2) times: most of level 0's shadow
    lanes are gated off and none is occluded."""
    calls = _capture_wavefronts(r)
    worst, attrs_ok = 1.0, True
    k1 = {"name": "bvh_closest_hit", "route": "cuda", "source": "rpt_tpu_torch/csrc/bvh_traverse.cu",
          "replaces": "rpt_tpu/intersect.py:699", "max_abs_err": 0.0}
    for label, (args, kwargs) in (("camera", calls["bvh_closest_hit"][0]),
                                  ("level-1 bounce", calls["bvh_closest_hit"][1])):
        numbers, share, ok = _k1_case(label, args, kwargs)
        worst, attrs_ok = min(worst, share), attrs_ok and ok
        k1["max_abs_err"] = max(k1["max_abs_err"], numbers["max_abs_err"])
        if label == "camera":
            k1["ms"], k1["plain_ms"] = numbers["ms"], numbers["plain_ms"]
            k1["bound_ms"], k1["bound_by"] = numbers["bound_ms"], numbers["bound_by"]
            k1["library_ms"] = None
        else:
            k1["bounce_ms"], k1["bounce_plain_ms"] = numbers["ms"], numbers["plain_ms"]

    # level 0's shadow rays leave the convex-ish mesh unoccluded; level 1's
    # start mostly on the plane, where the mesh shadows them
    k2 = {"name": "bvh_any_hit", "route": "cuda", "source": "rpt_tpu_torch/csrc/bvh_traverse.cu",
          "replaces": "rpt_tpu/intersect.py:767", "max_abs_err": 0.0}
    for level in (0, 1):
        args, kwargs = calls["bvh_any_hit"][level]
        numbers, share = _k2_case(f"level-{level} batched shadow wavefront", args, kwargs,
                                  r.compiled.t_min)
        worst = min(worst, share)
        k2["max_abs_err"] = max(k2["max_abs_err"], numbers["max_abs_err"])
        if level == 1:
            k2["ms"], k2["plain_ms"] = numbers["ms"], numbers["plain_ms"]
            k2["bound_ms"], k2["bound_by"] = numbers["bound_ms"], numbers["bound_by"]
            k2["library_ms"] = None
        else:
            k2["level0_ms"], k2["level0_plain_ms"] = numbers["ms"], numbers["plain_ms"]
    _check_traversal(worst, attrs_ok, "the dragon")
    return [k1, k2]


def phase_golden_path():
    """The sphere (64x36, 16 spp) and Cornell (48x48, 24 spp) renders, seed
    42, on the card against the JAX-made goldens under
    tests/test_golden.py::_check's limits (mean |diff| / mean < 0.015,
    p99 |diff| / mean < 0.12), with no floor."""
    import torch_cornell
    import torch_sphere

    ok = True
    for name, mod in (("sphere_64x36_16spp", torch_sphere), ("cornell_48x48_24spp", torch_cornell)):
        r = mod.renderer("cuda")
        img = r.render()
        raw = r._last_buffer.raw()
        ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy")).astype(np.float64)
        diff = np.abs(raw - ref)
        scale = max(ref.mean(), 1e-6)
        mean_rel, p99_rel = diff.mean() / scale, np.percentile(diff, 99) / scale
        good = bool(np.isfinite(raw).all()) and mean_rel < 0.015 and p99_rel < 0.12
        ok = ok and good
        print(f"[golden-path] {name}: mean |diff|/mean {mean_rel:.3e} (< 0.015), p99/mean "
              f"{p99_rel:.3e} (< 0.12), image mean {img.mean():.3f}; ok {good}")
    if not ok:
        raise RuntimeError("path-traced golden check failed")


def _sample0(r):
    """Sample 0's camera wavefront of a photon render: ``(ray, estimate
    keys, hit)`` as `_photon_pass` forms them."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.intersect import closest_hit
    from rpt_tpu_torch.renderer import camera_wavefront

    scene = r.compiled
    ray, keys = camera_wavefront(scene, r.camera, r.width_, r.height_,
                                 sampling.fold_in(sampling.key(r.seed_, r.device), 2), 0)
    return ray, sampling.fold(keys, 4), closest_hit(scene, scene.tables, ray)


def _zero_counts():
    """Zero the launch counts: the program's table (`tracing.LAUNCHES`, each
    kernel wrapper's launches by its name) and `KNN_BY_K`, whose counting
    wrapper this puts in place at the first call."""
    from rpt_tpu_torch import tracing

    tracing.LAUNCHES.clear()
    KNN_BY_K.clear()
    _count_knn_by_k()


def _launched(name: str) -> int:
    """The launches of the kernel wrapper ``name`` since `_zero_counts`."""
    from rpt_tpu_torch import tracing

    return tracing.LAUNCHES[name]


# K-knn's launches by k since `_zero_counts`, on the photon integrator's
# path (`_count_knn_by_k`)
KNN_BY_K: dict = {}


def _count_knn_by_k():
    """Wrap the photon integrator's `knn_query` (its module attribute, which
    the integrator reads at each call, as the benchmark's capture does) so
    that every call counts the K-knn launches it made in `KNN_BY_K` under
    its k. Once: a second call finds the wrapper in place."""
    from rpt_tpu_torch.accel import knn
    from rpt_tpu_torch.integrators import photon

    inner = photon.knn_query
    if inner is not knn.knn_query:
        return

    def by_k(grid, queries, k):
        before = _launched("knn_query")
        out = inner(grid, queries, k)
        if _launched("knn_query") > before:
            KNN_BY_K[k] = KNN_BY_K.get(k, 0) + _launched("knn_query") - before
        return out

    photon.knn_query = by_k


# K-prim's entry points, and their launches on every path the smoke drives,
# by path (`_read_prim`)
K_PRIM = ("prim_closest_hit", "prim_any_hit")
PRIM_LAUNCHES: dict = {}
# K-dense's entry points (the dense test of meshes of at most 8 leaf rows),
# and their launches on every path that made any, by path (`_read_dense`)
K_DENSE = ("dense_closest_hit", "dense_any_hit")
DENSE_LAUNCHES: dict = {}


def _read_prim(path: str) -> dict:
    """Record K-prim's launches of ``path`` since `_zero_counts` (adding to
    what an earlier run of the same path recorded) and fail where the path
    made no closest-hit query through K-prim: every path tests its rays
    against the analytic prims first (none in a scene without any)."""
    counts = {name: _launched(name) for name in K_PRIM}
    if counts["prim_closest_hit"] <= 0:
        raise RuntimeError(f"the {path} path never launched prim_closest_hit: {counts}")
    seen = PRIM_LAUNCHES.setdefault(path, dict.fromkeys(K_PRIM, 0))
    for name, n in counts.items():
        seen[name] += n
    return counts


def _read_dense(path: str, required: bool = False) -> dict:
    """Record K-dense's launches of ``path`` since `_zero_counts` where it
    made any (adding to what an earlier run of the same path recorded);
    with ``required``, fail where either entry never launched."""
    counts = {name: _launched(name) for name in K_DENSE}
    if required and min(counts.values()) <= 0:
        raise RuntimeError(f"the {path} path did not launch both K-dense entries: {counts}")
    if any(counts.values()):
        seen = DENSE_LAUNCHES.setdefault(path, dict.fromkeys(K_DENSE, 0))
        for name, n in counts.items():
            seen[name] += n
    return counts


# K-shoot's launches on every path that made any, by path (`_read_shoot`)
SHOOT_LAUNCHES: dict = {}


def _read_shoot(path: str, required: bool = False) -> dict:
    """Record K-shoot's launches of ``path`` since `_zero_counts` where it
    made any (adding to what an earlier run of the same path recorded);
    with ``required`` (a path that shoots photons on the card), fail where
    it made none: every shoot level on the card takes K-shoot."""
    counts = {"shoot_level": _launched("shoot_level")}
    if required and counts["shoot_level"] <= 0:
        raise RuntimeError(f"the {path} path shot photons but never launched K-shoot")
    if counts["shoot_level"]:
        seen = SHOOT_LAUNCHES.setdefault(path, {"shoot_level": 0})
        seen["shoot_level"] += counts["shoot_level"]
    return counts


# K-estimate's entry points (the photon map's estimates at the camera's
# hits), and their launches on every path that made any, by path
# (`_read_estimate`)
K_ESTIMATE = ("estimate_prep", "estimate_pairs", "estimate_finish")
ESTIMATE_LAUNCHES: dict = {}


def _read_estimate(path: str, required: bool = False) -> dict:
    """Record K-estimate's launches of ``path`` since `_zero_counts` where
    it made any (adding to what an earlier run of the same path recorded);
    with ``required`` (a path that estimates from a photon map on the
    card), fail where prep or finish never launched, or where they did not
    launch as often: every estimate on the card takes K-estimate."""
    counts = {name: _launched(name) for name in K_ESTIMATE}
    if required and (counts["estimate_prep"] <= 0
                     or counts["estimate_prep"] != counts["estimate_finish"]):
        raise RuntimeError(f"the {path} path estimated from a photon map but did not take "
                           f"K-estimate: {counts}")
    if any(counts.values()):
        seen = ESTIMATE_LAUNCHES.setdefault(path, dict.fromkeys(K_ESTIMATE, 0))
        for name, n in counts.items():
            seen[name] += n
    return counts


def _read_counts(path: str, shoots: bool = False, estimates: bool = False) -> dict:
    """The launches of K-knn, K-sweep, K1, K2, K-prim, K-dense, K-shoot and
    K-estimate since `_zero_counts`; K-rng's are recorded for ``path`` by
    `_read_rng`, K-prim's also by `_read_prim`, K-dense's by `_read_dense`,
    K-shoot's by `_read_shoot` (required where ``shoots``), K-estimate's by
    `_read_estimate` (required where ``estimates``)."""
    _read_rng(path, shoots)
    return {**{name: _launched(name) for name in ("knn_query", "knn_radius", "sphere_sweep",
                                                  "bvh_closest_hit", "bvh_any_hit")},
            "knn_query_by_k": dict(KNN_BY_K),
            **_read_dense(path), **_read_prim(path), **_read_shoot(path, shoots),
            **_read_estimate(path, estimates)}


def _other_launches(launches: dict, allowed=()) -> dict:
    """The launches of ``launches`` by kernels other than K-prim, K-dense
    (a scene's small meshes), K-shoot (a photon shoot's levels), K-estimate
    (a photon map's estimates) and ``allowed`` that were made."""
    return {name: n for name, n in launches.items()
            if n and name not in (*K_PRIM, *K_DENSE, "shoot_level", *K_ESTIMATE, *allowed)}


def _check_image(label, r, img):
    finite = bool(np.isfinite(r._last_buffer.raw()).all())
    if not finite or img.shape != (r.height_, r.width_, 3) or img.mean() <= 0:
        raise RuntimeError(f"{label} output is not a finite, non-black image of the right shape")
    return finite


def _capture_gathers(r):
    """Sample 0 of a photon render's camera pass once more, with K-knn's
    wrapper recording each call and timing it in place (CUDA events around
    the call inside the pass, host waits included): by ``(cloud, k)``, the
    queries of each of the sample's wavefronts and the ms of their calls."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.integrators import photon
    from rpt_tpu_torch.renderer import _photon_pass

    inner, calls = photon.knn_query, []

    def run(grid, q, k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(grid, q, k)
        end.record()
        calls.append((grid, q, k, start, end))
        return out

    photon.knn_query = run
    try:
        _photon_pass(r.compiled, r.camera, r.width_, r.height_, r.photon_map,
                     sampling.fold_in(sampling.key(r.seed_, r.device), 2), 1, r.gather_size_,
                     r.gather_size_volume_, True)
    finally:
        photon.knn_query = inner
    torch.cuda.synchronize()
    gathers = {}
    for grid, q, k, start, end in calls:
        cloud = "surface" if grid is r.photon_map.surface_grid else "volume"
        gathers.setdefault((cloud, k), []).append((q, start.elapsed_time(end)))
    return gathers


def _gather_case(label, grid, qs, k, in_pass_ms=None):
    """K-knn on one gather's queries, ``qs`` a list of wavefronts (all of a
    sample): the first against brute force (`_knn_compare`, every row; and
    bit-equal on the 256 rows of largest k-th d^2), brute force timed once;
    each wavefront timed by `_cold_ms` (its data out of L2, as in the
    render) and by `_time_ms` (warm), with its bound (`_gather_bound`); the
    counting variant over all of them. Times and bounds are means a
    wavefront. Returns the numbers of its kernel entry."""
    from rpt_tpu_torch.accel.knn import knn_plain, knn_query, knn_query_counts

    q = qs[0]
    (_, d2p, _), plain_ms = _events_ms(lambda: knn_plain(grid.points, q, k))
    same, exact, err, idx_ok = _knn_compare(grid, q, k, d2p)
    _, d2, valid = knn_query(grid, q, k)
    far = torch.topk(torch.where(valid[:, -1], d2[:, -1], -1.0), min(256, q.shape[0])).indices
    far_exact = float((d2[far] == d2p[far]).all(dim=1).float().mean())
    cold, warm, bounds, rows = [], [], [], []
    for w in qs:
        cold.append(_cold_ms(lambda: knn_query(grid, w, k), 5))
        warm.append(_time_ms(lambda: knn_query(grid, w, k), 5))
        idx, _, valid = knn_query(grid, w, k)
        bound_ms, bound_by, n_rows = _gather_bound(w, k, idx, valid)
        bounds.append(bound_ms)
        rows.append(n_rows)
    ms, warm_ms, bound_ms = (sum(v) / len(qs) for v in (cold, warm, bounds))
    c = torch.cat([knn_query_counts(grid, w, k) for w in qs])
    in_pass = "" if in_pass_ms is None else (
        f"; inside the render's pass {in_pass_ms:.3f} ms (events around the wrapper, host "
        f"waits included)")
    print(f"{label}: {len(qs)} wavefront(s) of {q.shape[0]} queries x {grid.n} points, k={k}: "
          f"the first against brute force: rows agreeing {same:.5f} (bit-equal {exact:.5f}; the "
          f"256 of largest k-th d^2 {far_exact:.5f}), max abs err {err:.3e}, indices consistent "
          f"{idx_ok}, plain {plain_ms:.3f} ms; kernel a wavefront {ms:.3f} ms with its data out "
          f"of L2 (by wavefront {', '.join(f'{t:.3f}' for t in cold)}), {warm_ms:.3f} ms warm{in_pass}; "
          f"bound {bound_ms * 1e3:.2f} us ({bound_by}; distinct points among the answers "
          f"{min(rows)}-{max(rows)} a wavefront), {ms / bound_ms:.1f}x; counts: levels "
          f"{_quantiles(c[:, 0])}; cells {_quantiles(c[:, 1])}; candidates {_quantiles(c[:, 2])} "
          f"(mean {float(c[:, 2].float().mean()):.1f})")
    if same < 1.0 or exact < KNN_ROW_AGREEMENT or far_exact < KNN_ROW_AGREEMENT or not idx_ok:
        raise RuntimeError(f"K-knn at k={k} agrees with brute force on {same:.5f} of rows "
                           f"(bit-equal {exact:.5f}, {far_exact:.5f} of the farthest), indices "
                           f"consistent {idx_ok}")
    numbers = {"max_abs_err": err, "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    if in_pass_ms is not None:
        numbers["in_pass_ms"] = in_pass_ms
    return numbers


def _knn_entry(k: int, path: str, launches: int, numbers: dict) -> dict:
    """A K-knn query kernel entry at ``k``, the gather size of ``path``,
    which launched it ``launches`` times; ``list`` is `query_by_k`'s list
    for k: ceil(k / 32) registers a lane, rounded up to 1, 2 or 4."""
    regs = next(r for r in (1, 2, 4) if k <= 32 * r)
    return {"name": f"knn_query_k{k}", "route": "cuda", "source": "rpt_tpu_torch/csrc/knn.cu",
            "replaces": "rpt_tpu/accel/grid.py:605", "path": path,
            "list": f"knn_query_kernel<WarpListR<{regs}>>", "launches": launches, **numbers}


def _beside(prefix: str, numbers: dict) -> dict:
    """A gather's numbers as side fields of another K-knn entry."""
    return {f"{prefix}_{key}": numbers[key]
            for key in ("max_abs_err", "ms", "warm_ms", "plain_ms", "bound_ms")}


def _side(prefix: str, numbers: dict) -> dict:
    """A K1/K2 case's times and bound as side fields of its kernel's entry."""
    return {f"{prefix}_{key}": numbers[key] for key in ("ms", "plain_ms", "bound_ms")}


def _wavefronts(r, spp: int) -> int:
    from rpt_tpu_torch.renderer import PIXEL_CHUNK

    return spp * -(-r.width_ * r.height_ // PIXEL_CHUNK)


def _misses(gathers) -> int:
    """Queries at the origin of space: the gather point of a ray that hits
    nothing (or, for the volume gather, whose collision lies past its hit)."""
    return sum(int((q == 0).all(dim=1).sum()) for q, _ in gathers)


def _in_pass_ms(gathers) -> float:
    return sum(ms for _, ms in gathers) / len(gathers)


def phase_photonmap(spp_cap):
    """The photon-map kind's main path at its example's parameters, then
    K-knn on sample 0's gathers, captured from its camera pass: the surface
    gather at k = 100 (its own), 50 (`Renderer`'s default), 64 and 128 (the
    widest of two and four registers a lane), and the volume gather (the
    sampled collisions) at k = 30, each against brute force. Returns
    ``(numbers by k, launches by k)``."""
    import torch_volumetric_photonphoton_lampshade as ex

    spp = _cut(ex.sample, spp_cap)
    r = ex.renderer("cuda", sample=spp, seed=0)
    _zero_counts()
    img = r.photon_map_render(ex.photons)
    launches = _read_counts("photonmap", shoots=True, estimates=True)
    s, c = r.phase_seconds, r.photon_counts
    finite = _check_image("photon-map render", r, img)
    note = "" if spp == ex.sample else f" (spp lowered from {ex.sample} to {spp})"
    print(f"[photonmap] {r.width_}x{r.height_} {spp} spp{note}, {ex.photons} photons, gather "
          f"{r.gather_size_} / {r.gather_size_volume_}: shoot {s['shoot']:.3f} s, build "
          f"{s['build']:.3f} s, trace {s['trace']:.3f} s ({s['trace'] / spp * 1e3:.1f} ms a "
          f"sample); surface {c['surface']}, volume {c['volume']}, dropped {c['dropped']}; "
          f"image mean {img.mean():.4f} (radiance {r._last_buffer.raw().mean():.5f}), finite "
          f"{finite}; launches {launches}")
    wavefronts = _wavefronts(r, spp)
    want = {r.gather_size_: wavefronts, r.gather_size_volume_: wavefronts}
    if launches["knn_query_by_k"] != want or launches["knn_query"] != 2 * wavefronts:
        raise RuntimeError(f"K-knn launched {launches['knn_query_by_k']}, not {want}")
    if launches["sphere_sweep"] or launches["knn_radius"]:
        raise RuntimeError("the photon-map render launched K-sweep or the radius pass")

    pmap = r.photon_map
    gathers = _capture_gathers(r)
    surface = gathers[("surface", r.gather_size_)]
    volume = gathers[("volume", r.gather_size_volume_)]
    label = f"[photonmap] K-knn surface gather ({_misses(surface)} misses at the origin)"
    qs = [q for q, _ in surface]
    numbers = {r.gather_size_: _gather_case(label, pmap.surface_grid, qs, r.gather_size_,
                                            _in_pass_ms(surface))}
    for k in (50, 64, 128):
        numbers[k] = _gather_case(label, pmap.surface_grid, qs, k)
    numbers[r.gather_size_volume_] = _gather_case(
        f"[photonmap] K-knn volume gather ({_misses(volume)} at the origin: no collision before "
        f"the hit)", pmap.volume_grid, [q for q, _ in volume], r.gather_size_volume_,
        _in_pass_ms(volume))
    return numbers, launches["knn_query_by_k"]


def phase_photonmap_default(spp_cap):
    """`examples/torch_photon_map.py` at its full size (512^2, 10 spp, 10M
    photons, 5 bounces) with `Renderer`'s default gather, 50 / 50: the
    scene has no medium, so each of a sample's 16 wavefronts launches K-knn
    once, at k = 50 over the surface photons, and no other hand-written
    kernel but K-rng. Then K-knn at k = 50 on sample 0's 16 gathers,
    captured from its camera pass: each timed, the first held to brute
    force. Returns ``(numbers, launches by k)``."""
    import torch_photon_map as ex

    spp = _cut(ex.sample, spp_cap)
    r = ex.renderer("cuda", sample=spp)
    _zero_counts()
    img = r.photon_map_render(ex.photons)
    launches = _read_counts("photonmap-default", shoots=True, estimates=True)
    s, c = r.phase_seconds, r.photon_counts
    finite = _check_image("photon_map.py render", r, img)
    raw = r._last_buffer.raw()
    note = "" if spp == ex.sample else f" (spp lowered from {ex.sample} to {spp})"
    print(f"[photonmap-default] {r.width_}x{r.height_} {spp} spp{note}, {ex.photons} photons, "
          f"{r.max_bounces_} bounces, gather {r.gather_size_} / {r.gather_size_volume_}: shoot "
          f"{s['shoot']:.3f} s, build {s['build']:.3f} s, trace {s['trace']:.3f} s "
          f"({s['trace'] / spp * 1e3:.1f} ms a sample); surface photons {c['surface']} "
          f"({_nbytes(r.photon_map.surface) / 2**30:.2f} GiB of rows), volume {c['volume']}, "
          f"dropped {c['dropped']}; image mean {img.mean():.4f} (radiance {raw.mean():.3e}, "
          f"non-black {bool(raw.max() > 0)}), finite {finite}; launches {launches}")
    wavefronts = _wavefronts(r, spp)
    want = {r.gather_size_: wavefronts}
    if launches["knn_query_by_k"] != want or launches["knn_query"] != wavefronts:
        raise RuntimeError(f"K-knn launched {launches['knn_query_by_k']}, not {want}")
    if _other_launches(launches, ("knn_query", "knn_query_by_k")):
        raise RuntimeError(f"the photon_map.py render launched another kernel: {launches}")

    surface = _capture_gathers(r)[("surface", r.gather_size_)]
    numbers = _gather_case(f"[photonmap-default] K-knn surface gather, sample 0 "
                           f"({_misses(surface)} misses at the origin)", r.photon_map.surface_grid,
                           [q for q, _ in surface], r.gather_size_, _in_pass_ms(surface))
    return numbers, launches["knn_query_by_k"]


def _opening_pixels(r) -> np.ndarray:
    """The (H, W) mask of the skybox pixels whose sample-0 camera ray
    leaves through the ceiling's opening: it misses every surface, or its
    first hit lies above the ceiling (the light over the hole)."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.intersect import closest_hit
    from rpt_tpu_torch.renderer import _pixel_grid, camera_wavefront

    scene = r.compiled
    ray, _ = camera_wavefront(scene, r.camera, r.width_, r.height_,
                              sampling.fold_in(sampling.key(r.seed_, r.device), 2), 0)
    hit = closest_hit(scene, scene.tables, ray)
    y = ray.origin.y + ray.dir.y * torch.where(hit.valid, hit.time, 0.0)
    out = (~hit.valid) | (y > 548.9 + 1e-3)
    inv = torch.tensor(_pixel_grid(r.width_, r.height_)[3], device=out.device)
    return out[inv].cpu().numpy().reshape(r.height_, r.width_)


def phase_skybox_photons(spp_cap):
    """`examples/torch_skybox_photons.py` at its full size (256^2, 100 spp,
    10M photons, 10 bounces, `Renderer`'s default gather 50 / 50): the
    photon map of the open foggy box under the sky, counts zeroed just
    before ``photon_map_render`` and read just after. The scene has a
    medium, so each wavefront gathers twice at k = 50: over the surface
    photons and, at its sampled collision, over the volume photons. Its 20
    triangles fill 3 leaf rows, under `ops.dense_tri_hit.DENSE_TRI_ROWS`, so they
    take K-dense and launch no K1/K2. Then both gathers on sample
    0's wavefronts, captured from its camera pass, against brute force.
    Returns ``(volume numbers, surface numbers, launches a gather, the
    renderer)``."""
    import torch_skybox_photons as ex

    spp = _cut(ex.SPP, spp_cap)
    r = ex.renderer("cuda", sample=spp)
    _zero_counts()
    img = r.photon_map_render(ex.PHOTONS)
    launches = _read_counts("skybox-photons", shoots=True, estimates=True)
    s, c = r.phase_seconds, r.photon_counts
    finite = _check_image("[skybox-photons]", r, img)
    raw = r._last_buffer.raw().mean(axis=2)
    opening = _opening_pixels(r)
    lit = float(raw[opening].mean()) if opening.any() else 0.0
    bvh = r.compiled.tables["bvh"]
    note = "" if spp == ex.SPP else f" (spp lowered from {ex.SPP} to {spp})"
    print(f"[skybox-photons] {r.width_}x{r.height_} {spp} spp{note}, {ex.PHOTONS} photons, "
          f"{r.max_bounces_} bounces, gather {r.gather_size_} / {r.gather_size_volume_}: shoot "
          f"{s['shoot']:.3f} s, build {s['build']:.3f} s, trace {s['trace']:.3f} s "
          f"({s['trace'] / spp * 1e3:.1f} ms a sample); surface photons {c['surface']}, volume "
          f"{c['volume']} ({_nbytes(r.photon_map.volume) / 2**30:.2f} GiB of rows), deposits "
          f"dropped at the capacities (4 and 10 a photon) {c['dropped']}; "
          f"{r.compiled.n_tris} triangles in {bvh.leaves.shape[0]} leaf rows (K-dense); "
          f"image mean {img.mean():.4f} (radiance {raw.mean():.3e}), the {int(opening.sum())} "
          f"pixels through the ceiling's opening {lit:.3e} ({lit / raw.mean():.2f}x the "
          f"image), finite {finite}; launches {launches}")
    if not opening.any() or lit <= raw.mean():
        raise RuntimeError("the sky above the opening is not lit in the skybox image")
    wavefronts = _wavefronts(r, spp)
    if launches["knn_query_by_k"] != {50: 2 * wavefronts} or launches["knn_query"] != 2 * wavefronts:
        raise RuntimeError(f"K-knn launched {launches['knn_query_by_k']}, not {2 * wavefronts} "
                           "gathers at k=50")
    if _other_launches(launches, ("knn_query", "knn_query_by_k")):
        raise RuntimeError(f"the skybox photon map launched another kernel: {launches}")

    gathers = _capture_gathers(r)
    volume, surface = gathers[("volume", 50)], gathers[("surface", 50)]
    pmap = r.photon_map
    vol = _gather_case(f"[skybox-photons] K-knn volume gather, sample 0 ({_misses(volume)} at "
                       f"the origin: no collision before the hit)", pmap.volume_grid,
                       [q for q, _ in volume], 50, _in_pass_ms(volume))
    surf = _gather_case(f"[skybox-photons] K-knn surface gather, sample 0 ({_misses(surface)} "
                        f"misses at the origin)", pmap.surface_grid, [q for q, _ in surface], 50,
                        _in_pass_ms(surface))
    return vol, surf, wavefronts, r


# What `[sharded]` holds the sharded passes to against the single-process
# ones: one rank traces the same lanes in the same (Morton) order and sums
# them in the same order, so bit-equal on >= 99.99% of pixels and within
# rtol 1e-5 on the rest. (In raster order K-sweep's partial sums split at
# other ray blocks: 10,733 of the point-beam lampshade's 16,384 pixels
# differed in the last bits.)
SHARDED_EQUAL = 0.9999
SHARDED_RTOL = 1e-5


def _sharded_compare(label, got, ref) -> int:
    """Pixels of a sharded sum that differ from the single-process one;
    raises outside the limits above."""
    ref = ref.astype(np.float32)
    equal = (got == ref).all(axis=1)
    close = np.isclose(got, ref, rtol=SHARDED_RTOL, atol=0.0).all()
    print(f"[sharded] {label}: {got.shape[0]} pixels, {int((~equal).sum())} differ from the "
          f"single-process pass (max abs {float(np.abs(got - ref).max()):.3e}); within rtol "
          f"{SHARDED_RTOL}: {close}; radiance mean {got.mean():.5f}")
    if equal.mean() < SHARDED_EQUAL or not close or not np.isfinite(got).all():
        raise RuntimeError(f"the sharded {label} disagrees with the single-process pass")
    return int((~equal).sum())


def phase_sharded(r_dragon, r_lamp):
    """`rpt_tpu_torch.parallel` over NCCL at world size 1 on the card, in
    this process (a `FileStore` in a temporary directory), through
    ``make_mesh(1)``: ``render_sharded`` on the dragon at bench.py's full
    size (512^2, 8 spp, 2 bounces) against `_path_pass` for the same key;
    on the point-beam lampshade ``shoot_photons_sharded`` (1M photons)
    against `_shoot_launch` at ``fold_in(key, 0)``, bit for bit, and
    ``photon_render_sharded`` (128^2, 50 spp, gather 20 / 3) over the map
    built from those rows against `_photon_pass`. The launch counts are
    zeroed just before the sharded calls and read just after, the
    references run after. Returns the launches of the sharded calls."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from rpt_tpu_torch import parallel, sampling
    from rpt_tpu_torch.integrators import photon as ph
    from rpt_tpu_torch.renderer import _path_pass, _photon_pass

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=timedelta(seconds=120))
        try:
            t0 = time.perf_counter()
            mesh = parallel.make_mesh(1)
            # NCCL sets up a communicator at a group's first collective
            for group in (None, mesh.get_group("dp"), mesh.get_group("sp")):
                dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
            torch.cuda.synchronize()
            print(f"[sharded] {mesh} over {dist.get_backend()}, world size "
                  f"{dist.get_world_size()}; group and mesh set up, first collectives run, in "
                  f"{time.perf_counter() - t0:.3f} s")
            r = r_dragon
            scene, key = r.compiled, sampling.key(r.seed_, "cuda")
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = parallel.render_sharded(scene, r.camera, r.width_, r.height_, r.num_samples_,
                                          r.max_bounces_, mesh, key)
            wall = time.perf_counter() - t0
            dragon = _read_counts("sharded render")
            t0 = time.perf_counter()
            ref, _ = _path_pass(scene, r.camera, r.width_, r.height_, key, 0, r.num_samples_,
                                r.max_bounces_)
            print(f"[sharded] dragon {r.width_}x{r.height_} {r.num_samples_} spp "
                  f"{r.max_bounces_} bounces: render_sharded {wall:.3f} s (_path_pass "
                  f"{time.perf_counter() - t0:.3f} s); launches {dragon}")
            _sharded_compare("dragon", got, ref)

            r = r_lamp
            scene, key = r.compiled, sampling.key(r.seed_, "cuda")
            photons = 1_000_000
            shoot_key = sampling.fold_in(key, 1)
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            surface, volume = parallel.shoot_photons_sharded(scene, shoot_key, photons, r.watts_,
                                                             ph.POINT_BEAM, mesh)
            t_shoot = time.perf_counter() - t0
            shoot = _read_counts("sharded shoot", shoots=True)
            li, _ = ph._find_object_light(scene)
            s_ref, v_ref, dropped = ph._shoot_launch(scene, scene.tables, li, r.watts_ / photons,
                                                     48, photons, sampling.fold_in(shoot_key, 0))
            same = (np.array_equal(surface, s_ref.cpu().numpy())
                    and np.array_equal(volume, v_ref.cpu().numpy()))
            print(f"[sharded] lampshade shoot_photons_sharded, {photons} photons: {t_shoot:.3f} s,"
                  f" surface {surface.shape[0]}, volume {volume.shape[0]} (dropped {dropped}); "
                  f"bit-equal to _shoot_launch at fold_in(key, 0): {same}; launches {shoot}")
            if not same:
                raise RuntimeError("shoot_photons_sharded differs from _shoot_launch")
            pmap = ph.build_photon_map(scene, scene.tables, torch.from_numpy(surface).cuda(),
                                       torch.from_numpy(volume).cuda(), ph.POINT_BEAM,
                                       r.gather_size_, r.gather_size_volume_,
                                       np.random.default_rng(r.seed_ + 17))
            camera_key = sampling.fold_in(key, 2)
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = parallel.photon_render_sharded(scene, r.camera, r.width_, r.height_,
                                                 r.num_samples_, pmap, ph.POINT_BEAM,
                                                 r.gather_size_, r.gather_size_volume_, mesh,
                                                 camera_key)
            wall = time.perf_counter() - t0
            lamp = _read_counts("sharded photon render", estimates=True)
            t0 = time.perf_counter()
            ref = _photon_pass(scene, r.camera, r.width_, r.height_, pmap, camera_key,
                               r.num_samples_, r.gather_size_, r.gather_size_volume_, True)
            print(f"[sharded] lampshade photon_render_sharded {r.width_}x{r.height_} "
                  f"{r.num_samples_} spp, gather {r.gather_size_} / {r.gather_size_volume_}: "
                  f"{wall:.3f} s (_photon_pass {time.perf_counter() - t0:.3f} s); launches "
                  f"{lamp}")
            _sharded_compare("point-beam lampshade", got, ref)
        finally:
            dist.destroy_process_group()
    launches = {name: dragon[name] + shoot[name] + lamp[name]
                for name in ("bvh_closest_hit", "bvh_any_hit", "sphere_sweep", "knn_query")}
    print(f"[sharded] launches of the sharded calls: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the sharded calls never launched {name}")
    return launches


# `[drivers]`: the cut at which every other new driver runs on the card.
DRIVER_SCALE, DRIVER_SPP = 4, 2
DRIVERS = ("glass", "metal", "wine_glass", "rustacean", "lego", "lighthouse", "fractal_teapots",
           "basic", "spheres", "compound", "cornell_mirror", "fractal_spheres", "cylinder",
           "monomial_glass", "volumetric", "skybox", "simple_video")


def phase_drivers():
    """The drivers that no other phase renders (`DRIVERS`; none is a photon
    render), each built through its ``renderer()`` on the card, then cut: a
    quarter of its width and height and `DRIVER_SPP` samples (the example's
    own where fewer; `simple_video` its first frame), and rendered, counts
    zeroed just before and read just after."""
    import importlib

    total = {}
    for name in DRIVERS:
        ex = importlib.import_module(f"torch_{name}")
        r = ex.renderer("cuda")
        r.width(max(8, r.width_ // DRIVER_SCALE)).height(max(8, r.height_ // DRIVER_SCALE))
        r.num_samples(min(r.num_samples_, DRIVER_SPP))
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts("drivers")
        finite = _check_image(f"[drivers] {name}", r, img)
        print(f"[drivers] {name}: {r.width_}x{r.height_} {r.num_samples_} spp "
              f"{r.max_bounces_} bounces{' (a medium)' if r.compiled.media else ''}, "
              f"{r.compiled.n_tris} triangles: {wall:.3f} s, image mean {img.mean():.4f}, "
              f"finite and non-black {finite}; launches {launches}")
        for key in ("bvh_closest_hit", "bvh_any_hit", *K_PRIM):
            total[key] = total.get(key, 0) + launches[key]
    return total


def _beams_reference(beams, medium, o, d, hit_time):
    """The beam x beam estimate beam by beam in float64 (photon.rs:503-593
    with ``t > 0``) for a few lanes: (n, 3)."""
    n = o.shape[0]
    zero = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    ext = float(medium.extinction(_vec(zero))[0])
    color = medium.color(_vec(zero)).to_array().double()
    o, d, hit_time = o.double(), d.double(), hit_time.double()
    acc = torch.zeros((n, 3), dtype=torch.float64, device=o.device)
    for b in range(beams.n_beams):
        start, bdir = beams.start[b].double(), beams.dir[b].double()
        length, radius, power = float(beams.length[b]), float(beams.radius[b]), beams.power[b]
        l = start[None, :] - o
        u = torch.nn.functional.normalize(torch.linalg.cross(l, bdir.expand_as(l)), dim=1)
        nn = torch.nn.functional.normalize(torch.linalg.cross(bdir.expand_as(u), u), dim=1)
        t = (nn * l).sum(1) / (nn * d).sum(1)
        qc = o + d * t[:, None]
        beam_t = ((qc - start) * bdir).sum(1)
        dist = (qc - (start + bdir * beam_t[:, None])).norm(dim=1)
        ok = (t > 0) & (t < hit_time) & (beam_t >= 0) & (beam_t <= length) & (dist < radius)
        cosb = (d * bdir).sum(1)
        inv_sin = 1.0 / torch.sqrt(torch.clamp(1.0 - cosb * cosb, min=1e-12))
        ph = medium.phase(_vec(-bdir.float().expand(n, 3)), _vec(-d.float())).double()
        x = 1.0 - dist / radius
        w = (ext * ph * inv_sin * torch.exp(-ext * t) * torch.exp(-ext * beam_t)
             * (3.0 / np.pi) * x * x / (2.0 * radius))
        acc += torch.where(ok, w, 0.0)[:, None] * power.double()[None, :]
    return (acc * color).float()


def _vec(a):
    from rpt_tpu_torch.vec import Vec3

    return Vec3(a[:, 0], a[:, 1], a[:, 2])


def _estimate_agreement(got, ref) -> float:
    close = torch.isclose(got, ref, rtol=ESTIMATE_RTOL, atol=1e-6 * float(ref.abs().max()))
    return float(close.all(dim=1).float().mean())


def phase_beambeam(spp_cap):
    """The beam x beam kind's main path at its example's parameters; its
    beam estimate (torch ops) timed on sample 0's wavefront and held to the
    beam-by-beam reference on 256 lanes spread over the wavefront."""
    import torch_volumetric_beambeam_lampshade as ex
    from rpt_tpu_torch.integrators.photon import volume_estimate_beams
    from rpt_tpu_torch.ray import Ray

    spp = _cut(ex.sample, spp_cap)
    r = ex.renderer("cuda", sample=spp, seed=0)
    _zero_counts()
    img = r.photon_beam_query_beam_render(ex.photons)
    launches = _read_counts("beambeam", shoots=True, estimates=True)
    s, c = r.phase_seconds, r.photon_counts
    finite = _check_image("beam-beam render", r, img)
    beams = r.photon_map.beams
    note = "" if spp == ex.sample else f" (spp lowered from {ex.sample} to {spp})"
    print(f"[beambeam] {r.width_}x{r.height_} {spp} spp{note}, {ex.photons} photons, gather "
          f"{r.gather_size_}: shoot {s['shoot']:.3f} s, build {s['build']:.3f} s, trace "
          f"{s['trace']:.3f} s ({s['trace'] / spp * 1e3:.1f} ms a sample); surface "
          f"{c['surface']}, volume {c['volume']}, beams kept {beams.n_beams}; image mean "
          f"{img.mean():.4f}, finite {finite}; launches {launches}")
    wavefronts = _wavefronts(r, spp)
    if launches["knn_query_by_k"] != {r.gather_size_: wavefronts}:
        raise RuntimeError(f"K-knn launched {launches['knn_query_by_k']}, not one surface gather "
                           f"per wavefront ({wavefronts})")
    if launches["sphere_sweep"] or launches["knn_radius"] or not beams.n_beams:
        raise RuntimeError("the beam-beam render launched K-sweep or the radius pass, or kept "
                           "no beam")

    medium = r.compiled.media[0]
    ray, _, hit = _sample0(r)
    got = volume_estimate_beams(r.photon_map, medium, ray, hit).to_array()
    ms = _time_ms(lambda: volume_estimate_beams(r.photon_map, medium, ray, hit), 5)
    lanes = torch.arange(0, ray.origin.x.shape[0], max(1, ray.origin.x.shape[0] // 256),
                         device=ray.origin.x.device)[:256]
    few = Ray(ray.origin[lanes], ray.dir[lanes])
    hit_time = torch.where(hit.valid, hit.time, float("inf"))[lanes]
    ref, ref_ms = _events_ms(lambda: _beams_reference(beams, medium, few.origin.to_array(),
                                                      few.dir.to_array(), hit_time))
    share = _estimate_agreement(got[lanes], ref)
    lit = float((ref > 0).any(dim=1).float().mean())
    err = float((got[lanes] - ref).abs().max())
    print(f"[beambeam] beam estimate (torch ops): {got.shape[0]} lanes x {beams.n_beams} beams "
          f"{ms:.3f} ms a sample; against the beam-by-beam float64 reference on 256 lanes "
          f"({lit:.3f} of them cross a beam; reference {ref_ms:.1f} ms): within rtol "
          f"{ESTIMATE_RTOL} on {share:.4f} of lanes, max abs err {err:.3e} of max "
          f"{float(ref.max()):.3e}")
    if share < ESTIMATE_AGREEMENT or lit <= 0 or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the beam estimate agrees with its reference on {share:.4f} of lanes")
    return launches["knn_query"]


def phase_directional_sweep(r):
    """The sphere sweep of a medium whose phase depends on the directions
    (torch ops on the card, as it is XLA in the JAX package), on the
    point-beam render's spheres: a Henyey-Greenstein medium with g = 0 has
    the isotropic constant, so 2048 lanes of it are held to K-sweep; then
    one timed call over sample 0's whole wavefront with g = 0.6."""
    import rpt_tpu_torch as rpt
    from rpt_tpu_torch.integrators.photon import volume_estimate_spheres
    from rpt_tpu_torch.ray import Hit, Ray

    pmap, iso = r.photon_map, r.compiled.media[0]
    ray, _, hit = _sample0(r)
    ext = float(iso.extinction(ray.origin[0:1])[0])
    lanes = slice(0, ray.origin.x.shape[0], max(1, ray.origin.x.shape[0] // 2048))
    few = Ray(ray.origin[lanes], ray.dir[lanes])
    few_hit = Hit(hit.time[lanes], hit.normal[lanes], hit.material[lanes])
    g0 = rpt.Medium.henyey_greenstein(0.0, ext, 0.0)
    got = volume_estimate_spheres(pmap, g0, few, few_hit).to_array()
    ref = volume_estimate_spheres(pmap, iso, few, few_hit).to_array()
    share = _estimate_agreement(got, ref)
    hg = rpt.Medium.henyey_greenstein(0.0, ext, 0.6)
    out, ms = _events_ms(lambda: volume_estimate_spheres(pmap, hg, ray, hit).to_array())
    ratio = float(out.mean() / volume_estimate_spheres(pmap, iso, ray, hit).to_array().mean())
    print(f"[sweep-phase] directional sweep (torch ops): g = 0 against K-sweep on "
          f"{got.shape[0]} lanes x {pmap.spheres.n_spheres} spheres within rtol {ESTIMATE_RTOL} "
          f"on {share:.4f} of lanes; g = 0.6 over {out.shape[0]} lanes {ms:.1f} ms a sample, "
          f"mean {ratio:.3f} of the isotropic estimate, finite "
          f"{bool(torch.isfinite(out).all())}")
    if share < ESTIMATE_AGREEMENT or not bool(torch.isfinite(out).all()) or ratio == 1.0:
        raise RuntimeError(f"the directional sweep agrees with K-sweep on {share:.4f} of lanes")


def phase_volpath(spp: int):
    """The volumetric path tracer at its example's width through
    `iterative_render`, its 1000 samples cut to ``spp``; one untimed
    warm-up sample first. The lampshade's 12 triangles take the dense
    test, so the path launches no hand-written kernel but K-rng, K-prim
    (its six cubes) and K-dense (its triangles)."""
    import torch_volumetric_pathtrace_lampshade as ex
    from rpt_tpu_torch import Buffer
    from rpt_tpu_torch.renderer import RayCounter

    r = ex.renderer("cuda", sample=spp, seed=0)
    r.sample(1, Buffer(r.width_, r.height_, r.filter_))
    r._sample_index, r.ray_counter = 0, RayCounter()
    calls = []
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buffer = r.iterative_render(ex.every_x, lambda i, b: calls.append(i))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts("volpath")
    raw, img = buffer.raw(), buffer.image()
    segs = r.ray_counter.segments
    finite = bool(np.isfinite(raw).all())
    print(f"[volpath] {r.width_}x{r.height_}, media depth {r.media_max_depth_}, {spp} spp (cut "
          f"from the example's {ex.sample}), callbacks at {calls}: wall {wall:.3f} s, "
          f"{wall / spp:.4f} s a sample, {segs} ray segments ({segs / spp / r.width_ / r.height_:.2f}"
          f" a path), {segs / wall / 1e6:.3f} Mrays/s; image mean {img.mean():.4f} (radiance "
          f"{raw.mean():.5f}), finite {finite}; launches {launches}")
    if not finite or img.shape != (r.height_, r.width_, 3) or img.mean() <= 0:
        raise RuntimeError("volumetric render is not a finite, non-black image of the right shape")
    if not calls or calls[-1] != spp or segs <= spp * r.width_ * r.height_:
        raise RuntimeError("iterative_render did not trace every sample")
    if (_other_launches(launches) or launches["prim_any_hit"] <= 0
            or min(launches[name] for name in K_DENSE) <= 0):
        raise RuntimeError(f"the lampshade's volumetric path launched K1/K2, K-knn or K-sweep, "
                           f"or no K-prim shadow query, or no K-dense query: {launches}")


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npy")).astype(np.float64)


def phase_golden_media():
    """The three media goldens on the card with tests/test_golden.py's
    settings (:78-94, :111-123): the volumetric path under `_check(
    tol_mean=0.03, tol_p99=0.25)` and the photon map under `_check_img`
    (mean 0.02, p99 0.2 of the golden's mean), neither with a floor. The
    beam-beam golden's mean is 2.41 u8 levels and it encodes the JAX grid's
    truncated neighbour sets (tests/test_torch_photon_kinds.py shows that
    with those the port meets the unmodified limits): its p99 limit is
    floored at one level and its mean limit is 0.05, for this golden only."""
    import torch_volumetric_beamphoton_lampshade as ex

    def renderer(spp):
        return ex.renderer("cuda", size=32, bounce=6, sample=spp, photons=4000, seed=42)

    r = renderer(6).media_max_depth(8)
    r.render()
    raw, ref = r._last_buffer.raw(), _golden("lampshade_path_32_6spp")
    diff, scale = np.abs(raw - ref), max(ref.mean(), 1e-6)
    mean_rel, p99_rel = diff.mean() / scale, np.percentile(diff, 99) / scale
    ok = bool(np.isfinite(raw).all()) and mean_rel < 0.03 and p99_rel < 0.25
    print(f"[golden-media] lampshade_path_32_6spp: mean |diff|/mean {mean_rel:.4f} (< 0.03), "
          f"p99/mean {p99_rel:.4f} (< 0.25); ok {ok}")
    for name, method, mean_limit, p99_floor in (
            ("lampshade_photonmap_32", "photon_map_render", 0.02, 0.0),
            ("lampshade_beambeam_32", "photon_beam_query_beam_render", 0.05, 1.0)):
        img = getattr(renderer(2), method)(4000).astype(np.float64)
        ref = _golden(name)
        diff, scale = np.abs(img - ref), max(ref.mean(), 1e-6)
        mean_rel, p99 = diff.mean() / scale, np.percentile(diff, 99)
        limit = max(0.2 * scale, p99_floor)
        good = mean_rel < mean_limit and (p99 <= limit if p99_floor else p99 < limit)
        ok = ok and good
        print(f"[golden-media] {name}: golden mean {scale:.2f} levels, mean |diff|/mean "
              f"{mean_rel:.4f} (< {mean_limit}), p99 |diff| {p99:.1f} levels (limit {limit:.3f}; "
              f"p99/mean {p99 / scale:.4f}, unfloored limit 0.2), values differing "
              f"{int((diff > 0).sum())} of {diff.size}; ok {good}")
    if not ok:
        raise RuntimeError("media golden check failed")


def _brightest_direction(hdri) -> torch.Tensor:
    """The unit direction of an `Hdri`'s brightest texel (the sun of the
    procedural sky), inverting `Hdri.get_color`'s mapping."""
    lum = hdri._buf.sum(axis=2)
    row, col = np.unravel_index(int(lum.argmax()), lum.shape)
    polar = row / (hdri.height - 1) * np.pi
    azimuth = col / (hdri.width - 1) * 2.0 * np.pi - np.pi
    return torch.tensor([np.sin(polar) * np.cos(azimuth), np.cos(polar),
                         np.sin(polar) * np.sin(azimuth)], dtype=torch.float32)


def phase_pegasus(spp_cap):
    """`examples/torch_pegasus.py` at its full size: `data/pegasus.obj`
    loaded (100,138 triangles), 1200x1200, 10 spp (``--spp`` caps it), 8
    bounces, the ice under the sky; one untimed warm-up sample, then
    ``render()`` with the launch counts zeroed just before it and read just
    after. The scene has no light but the sky, so the path casts no shadow
    ray: K1 on every level, K2 never."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import _torch_assets
    import torch_pegasus as ex
    from rpt_tpu_torch import Buffer
    from rpt_tpu_torch.renderer import RayCounter

    t0 = time.perf_counter()
    mesh = _torch_assets.get_mesh("pegasus")
    t_load = time.perf_counter() - t0
    spp = _cut(ex.SPP, spp_cap)
    r = ex.renderer("cuda", sample=spp, scene=ex.build_scene(mesh))
    compiled = r.compiled
    torch.cuda.synchronize()
    host, env = compiled.build_seconds, compiled.environment
    print(f"[pegasus] data/pegasus.obj: {compiled.n_tris} triangles, loaded in {t_load:.3f} s; "
          f"SAH build {host['sah']:.3f} s, pack {host['pack']:.3f} s; sky {env.height}x"
          f"{env.width} (procedural: no .hdr in the repository)")
    if compiled.n_tris != 100138:
        raise RuntimeError(f"pegasus.obj gave {compiled.n_tris} triangles, not 100138")

    r.sample(1, Buffer(r.width_, r.height_, r.filter_))
    r._sample_index, r.ray_counter = 0, RayCounter()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts("pegasus")
    segs, raw = r.ray_counter.segments, r._last_buffer.raw()
    finite = _check_image("[pegasus]", r, img)
    note = "" if spp == ex.SPP else f" (spp lowered from {ex.SPP} to {spp})"
    print(f"[pegasus] {r.width_}x{r.height_} {spp} spp{note} {r.max_bounces_} bounces: wall "
          f"{wall:.3f} s, {segs} ray segments ({segs / spp / r.width_ / r.height_:.2f} a path), "
          f"{segs / wall / 1e6:.3f} Mrays/s; image mean {img.mean():.4f} (radiance "
          f"{raw.mean():.5f}), top row {raw[0].mean():.5f}, finite {finite}; launches "
          f"{launches}")
    if raw[0].mean() <= 0:
        raise RuntimeError("the sky does not show in the pegasus image's top row")
    if launches["bvh_closest_hit"] <= 0:
        raise RuntimeError("the pegasus render never launched bvh_closest_hit")
    return r, launches


def phase_pegasus_wavefronts(r):
    """K1 on sample 0's camera wavefront (of the render's 262,144-lane
    chunks, the one with the most mesh hits) and on its level-1 and level-2
    bounces, whose rays start on and inside the ice; K2 on a sun-shadow
    wavefront built here from that camera wavefront's hits toward the
    sky's brightest texel (the path casts none: the scene has no light);
    each against its plain version. Then `Hdri.get_color` on the card
    against the same call on the CPU on sample 0's level-0 misses, and the
    lookup timed over a chunk, as the path makes it on every lane of every
    level."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.intersect import closest_hit
    from rpt_tpu_torch.ops.bvh_traverse import _ray, bvh_closest_hit
    from rpt_tpu_torch.renderer import camera_wavefront

    scene, tables = r.compiled, r.compiled.tables
    calls = _capture_wavefronts(r)["bvh_closest_hit"]
    levels = r.max_bounces_ + 1
    if len(calls) % levels:
        raise RuntimeError(f"{len(calls)} K1 calls in sample 0 for {levels} levels a chunk")
    cameras = calls[::levels]
    hits = [int((bvh_closest_hit(*a, **k)[1] >= 0).sum()) for a, k in cameras]
    c = int(np.argmax(hits))
    print(f"[pegasus] sample 0: {len(cameras)} chunks x {levels} levels of K1 calls; mesh hits a "
          f"camera chunk {hits}; chunk {c} held against the plain version")
    worst, attrs_ok, out = 1.0, True, {}
    for level, label in ((0, "camera"), (1, "level-1 bounce"), (2, "level-2 bounce")):
        args, kwargs = calls[c * levels + level]
        numbers, share, ok = _k1_case(f"pegasus {label}", args, kwargs)
        worst, attrs_ok = min(worst, share), attrs_ok and ok
        out[label] = numbers

    # the sun-shadow wavefront: from the camera chunk's hits toward the sun
    args, _ = cameras[c]
    o, d = args[1], args[2]
    hit = closest_hit(scene, tables, _ray(o, d))
    pos = _ray(o, d).at(hit.time).to_array()
    pos = torch.where(hit.valid[:, None], pos, torch.zeros_like(pos)).contiguous()
    sun = _brightest_direction(scene.environment).to("cuda").expand_as(pos).contiguous()
    limit = torch.where(hit.valid, 4.0 * scene.scale, -1.0).to(torch.float32).contiguous()
    numbers, share = _k2_case("pegasus sun-shadow wavefront (built here: no light in the scene)",
                              (args[0], pos, sun, scene.t_min, limit), {}, scene.t_min)
    worst = min(worst, share)
    out["shadow"] = numbers
    _check_traversal(worst, attrs_ok, "the pegasus")

    # the sky on the card against the CPU, on sample 0's level-0 misses
    env = scene.environment
    ray, _ = camera_wavefront(scene, r.camera, r.width_, r.height_,
                              sampling.key(r.seed_, r.device), 0)
    miss = ~closest_hit(scene, tables, ray).valid
    dirs = ray.dir[miss]
    got = env.get_color(tables["env"], dirs).to_array().cpu()
    ref = env.get_color(env.tables("cpu"), dirs.map(lambda t: t.cpu())).to_array()
    peak = float(env._buf.max())
    ok = bool(torch.isclose(got, ref, rtol=1e-5, atol=1e-6 * peak).all())
    chunk = ray.dir[:262144]
    lookup_ms = _time_ms(lambda: env.get_color(tables["env"], chunk), 10)
    print(f"[pegasus] Hdri.get_color on the card against the CPU on {dirs.shape[0]} level-0 "
          f"misses of {miss.numel()} lanes: max abs err {float((got - ref).abs().max()):.3e} "
          f"(map peak {peak:.2f}), within rtol 1e-5 / atol 1e-6 of the peak: {ok}; the lookup "
          f"over a 262,144-lane chunk {lookup_ms:.3f} ms")
    if not ok or not bool(miss.any()):
        raise RuntimeError("Hdri.get_color on the card disagrees with the CPU")
    return out


def phase_teapot():
    """`examples/torch_teapot.py` at its full size (800x800, 1 spp, no
    bounce): `data/teapot.obj`, 2,256 triangles, under a point light, so
    the path launches K1 for its camera rays and K2 for their shadow rays;
    counts zeroed just before ``render()`` and read just after. Then K1 and
    K2 on the first chunk's camera and shadow wavefronts against their
    plain versions."""
    import torch_teapot as ex

    r = ex.renderer("cuda")
    compiled = r.compiled
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts("teapot")
    finite = _check_image("[teapot]", r, img)
    print(f"[teapot] {compiled.n_tris} triangles, {r.width_}x{r.height_} {r.num_samples_} spp: "
          f"wall {wall:.3f} s, image mean {img.mean():.4f}, finite {finite}; launches {launches}")
    for name in ("bvh_closest_hit", "bvh_any_hit"):
        if launches[name] <= 0:
            raise RuntimeError(f"the teapot render never launched {name}")
    calls = _capture_wavefronts(r)
    k1, share1, ok = _k1_case("teapot camera", *calls["bvh_closest_hit"][0])
    k2, share2 = _k2_case("teapot level-0 shadow wavefront", *calls["bvh_any_hit"][0],
                          compiled.t_min)
    _check_traversal(min(share1, share2), ok, "the teapot")
    return launches, k1, k2


def phase_marbles(spp_cap):
    """`examples/torch_marbles.py`'s first two frames at 800x600 and 9
    bounces, each with the launch counts zeroed just before its render and
    read just after, its samples cut to ``--spp`` (16 when left out; the
    example's 2000 would take minutes a frame); between the frames one
    frame's RK4 integration of `MarblesSystem` on the card (625 steps of
    1e-4 s and the remainder), timed. No mesh of the scene has more than
    two triangles, so the path launches no hand-written kernel but K-rng and
    K-prim (its 25 spheres and the monomial glass)."""
    import _torch_assets
    import torch_marbles as ex
    from rpt_tpu_torch import MarblesSystem

    spp = _cut(ex.SPP, 16 if spp_cap is None else spp_cap)
    state, system = ex.initial_state("cuda"), MarblesSystem(radius=ex.R)
    hdri = _torch_assets.get_hdri("ballroom_8k")
    start = state.pos.to_numpy()
    for frame in range(2):
        r = ex.renderer("cuda", ex.marble_positions(state), hdri, sample=spp)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts("marbles")
        finite = _check_image("[marbles]", r, img)
        segs = r.ray_counter.segments
        t0 = time.perf_counter()
        state = system.rk4_integrate(state, ex.FRAME_TIME, ex.STEP)
        torch.cuda.synchronize()
        rk4 = time.perf_counter() - t0
        moved = float(np.abs(state.pos.to_numpy() - start).max())
        print(f"[marbles] frame {frame}: {r.width_}x{r.height_} {spp} spp (cut from the example's "
              f"{ex.SPP}) {r.max_bounces_} bounces: wall {wall:.3f} s, {segs} ray segments, "
              f"{segs / wall / 1e6:.3f} Mrays/s, image mean {img.mean():.4f}, finite {finite}; "
              f"RK4 over the frame ({int(ex.FRAME_TIME / ex.STEP)} steps of {ex.STEP} s) "
              f"{rk4:.3f} s on the card, marbles moved up to {moved:.4f} since frame 0; "
              f"launches {launches}")
        if not bool(state.pos.isfinite().all()) or moved <= 0:
            raise RuntimeError("the marbles' RK4 state is not finite or did not move")
        if _other_launches(launches):
            raise RuntimeError(f"the marbles' path launched K1/K2, K-knn or K-sweep: {launches}")


# K-prim against its plain version (the per-type chain of torch ops on the
# card): hit or miss and material equal on >= 99.99% of lanes (K1's
# criterion: a float32 grazing hit may flip a lane), and where they agree
# the time within rtol 1e-6 and the normal within atol 1e-6; the any-hit
# flags equal on >= 99.99% of lanes.
PRIM_AGREEMENT = 0.9999
PRIM_RTOL, PRIM_ATOL = 1e-6, 1e-6
# K-prim's float32 operations, counted from `csrc/prim_hit.cu` (a division,
# a square root or a reciprocal as one): a sphere pair (the inverse
# transform 33, the quadratic 16, its roots and tests 11), a cube pair (the
# transform, three slabs of 7, the faces' choice and tests 17), a plane pair
# (two dot products 11, the on-plane guard 14, the tests 6), a monomial's
# box test (the transform, three coefficients 12, three slabs of 8, the
# feasibility test 10) and, for a pair inside its box before the best, its
# search: 60 bisection steps of a distance (12) and a midpoint (2), the
# Newton steps (at most 10 of ~50) left out.
SPHERE_OPS, CUBE_OPS, PLANE_OPS, MONO_BOX_OPS, MONO_SEARCH_OPS = 60, 71, 31, 79, 840
RAY_BYTES, HIT_BYTES = 24, 20  # six float32 in; time, normal, material out


def _prim_bound(prims, ray, t_min, out_bytes: int, scan=None, extra_ops: float = 0.0):
    """K-prim's bound on one wavefront: the rays in, ``out_bytes`` (the
    outputs and the any-hit limits) and the rows once; the pair tests of
    every lane that must test every prim (those in ``scan``, else all), the
    monomials' searches that this data needs and ``extra_ops``."""
    n = ray.origin.x.numel()
    c = prims.counts
    per_lane = c[0] * SPHERE_OPS + c[1] * CUBE_OPS + c[2] * PLANE_OPS + c[3] * MONO_BOX_OPS
    lanes = n if scan is None else int(scan.sum())
    ops = (lanes * per_lane + monomial_searches(prims, ray, t_min, scan) * MONO_SEARCH_OPS
           + extra_ops)
    return _bound(n * RAY_BYTES + out_bytes + _nbytes(prims.rows), ops)


def monomial_searches(prims, ray, t_min, lanes=None) -> int:
    """How many (lane, monomial) pairs pass the monomial's box test against
    the best hit entering the monomial batch (the per-type chain's, over
    the spheres, cubes and planes), and so run the Newton and bisection
    search in K-prim (of the lanes in the bool mask ``lanes``, where
    given): the data-dependent part of K-prim's work, for its bound. The
    box is [-1, 0, -1] .. [1, h, 1] in the monomial's object space, as
    `intersect_monomials` tests it."""
    from rpt_tpu_torch.ops.prim_hit import PrimRows, prim_closest_hit_plain
    from rpt_tpu_torch.ray import aabb_interval
    from rpt_tpu_torch.vec import Vec3

    if not prims.counts[3]:
        return 0
    front = PrimRows(prims.rows[:sum(prims.counts[:3])], (*prims.counts[:3], 0),
                     {k: v for k, v in prims.sets.items() if k != "monomials"})
    entry = prim_closest_hit_plain(front, ray, t_min).time
    mono = prims.sets["monomials"]
    total = 0
    for i in range(mono.n):
        local = ray.transform(mono.world_to_obj[i])
        h = mono.param[i]
        one = torch.ones_like(h)
        b_min, b_max = aabb_interval(local, Vec3.of(-1.0, 0.0, -1.0, device=h.device),
                                     Vec3(one, h, one))
        feasible = torch.clamp(b_min, min=t_min) <= torch.minimum(b_max, entry)
        total += int((feasible if lanes is None else feasible & lanes).sum())
    return total


def _bit_equal(a, b):
    return a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)


def _prim_case(label, prims, ray, t_min):
    """K-prim's closest hit against the per-type chain on one captured
    wavefront: ``(numbers, share, ok)``: the lanes whose hit or miss and
    material agree, and whether time and normal agree where they do."""
    from rpt_tpu_torch.ops.prim_hit import prim_closest_hit, prim_closest_hit_plain

    got = prim_closest_hit(prims, ray, t_min)
    ref, plain_ms = _events_ms(lambda: prim_closest_hit_plain(prims, ray, t_min))
    ms = _time_ms(lambda: prim_closest_hit(prims, ray, t_min), 5)
    hit = torch.isfinite(ref.time)
    same = (torch.isfinite(got.time) == hit) & (got.material == ref.material)
    share = float(same.float().mean())
    both = same & hit
    t_err = float((got.time - ref.time)[both].abs().max()) if bool(both.any()) else 0.0
    n_diff = (got.normal.to_array() - ref.normal.to_array())[both].abs()
    n_err = float(n_diff.max()) if bool(both.any()) else 0.0
    t_ok = bool(torch.isclose(got.time[both], ref.time[both], rtol=PRIM_RTOL, atol=0.0).all())
    n_ok = n_err <= PRIM_ATOL
    t_bits = _bit_equal(got.time, ref.time)
    n_bits = (_bit_equal(got.normal.x, ref.normal.x) & _bit_equal(got.normal.y, ref.normal.y)
              & _bit_equal(got.normal.z, ref.normal.z))
    bits = t_bits & n_bits & (got.material == ref.material)
    n = got.time.numel()
    bound_ms, bound_by = _prim_bound(prims, ray, t_min, n * HIT_BYTES)
    print(f"[K-prim] {label}: {n} lanes x {prims.n} prims {prims.counts} "
          f"({float(hit.float().mean()):.4f} hit): hit and material equal on {share:.6f} "
          f"({int((~same).sum())} lanes differ); "
          f"where equal max abs err t {t_err:.3e}, normal {n_err:.3e}, t ok {t_ok}, normal ok "
          f"{n_ok}; bit-equal lanes {int(bits.sum())} of {n} (time differs on "
          f"{int((~t_bits).sum())}, normal on {int((~n_bits).sum())}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    numbers = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": max(t_err, n_err), "bit_equal_lanes": int(bits.sum()), "lanes": n}
    return numbers, share, t_ok and n_ok


def _prim_any_case(label, prims, ray, t_min, limit):
    """K-prim's any hit against the per-type chain's ``time < limit`` on one
    captured shadow wavefront: ``(numbers, share)``."""
    from rpt_tpu_torch.ops.prim_hit import prim_any_hit, prim_any_hit_plain

    got = prim_any_hit(prims, ray, t_min, limit)
    ref, plain_ms = _events_ms(lambda: prim_any_hit_plain(prims, ray, t_min, limit))
    ms = _time_ms(lambda: prim_any_hit(prims, ray, t_min, limit), 5)
    share = float((got == ref).float().mean())
    live = (torch.as_tensor(limit) > t_min).expand_as(ref)
    n = got.numel()
    # an unoccluded live lane must test every prim; an occluded one at
    # least one
    bound_ms, bound_by = _prim_bound(prims, ray, t_min, n * 5, live & ~ref,
                                     int((live & ref).sum()) * SPHERE_OPS)
    print(f"[K-prim] {label}: {n} lanes x {prims.n} prims ({int((~live).sum())} gated off: "
          f"limit <= t_min; {float(ref.float().mean()):.4f} occluded): flag equal on "
          f"{share:.6f} ({int((got != ref).sum())} lanes differ); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    numbers = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": float((got.float() - ref.float()).abs().max()), "lanes": n}
    return numbers, share


def phase_fractal(smi: str):
    """`examples/torch_fractal_spheres.py` at its example's parameters,
    uncut: 800x600, 1 spp, no bounce, 937 spheres in five groups and a
    plane under ambient, directional and point lights; the counts zeroed
    just before ``render()`` and read just after. Each chunk's camera rays
    take one K-prim closest-hit launch and its two lights' shadow rays one
    any-hit launch; the per-type chain (`intersect_spheres` and its
    siblings) must not run."""
    import torch_fractal_spheres as ex
    from rpt_tpu_torch.ops import prim_hit

    r = ex.renderer("cuda")
    compiled = r.compiled
    counts = compiled.prim_rows.counts
    if counts != (937, 0, 1, 0) or compiled.n_tris:
        raise RuntimeError(f"the fractal compiled to {counts} prims, {compiled.n_tris} triangles")
    per_type = ("intersect_spheres", "intersect_cubes", "intersect_planes", "intersect_monomials")
    saved = {name: getattr(prim_hit, name) for name in per_type}
    plain_calls = dict.fromkeys(per_type, 0)

    def counted(name):
        def run(*args, **kwargs):
            plain_calls[name] += 1
            return saved[name](*args, **kwargs)
        return run

    for name in per_type:
        setattr(prim_hit, name, counted(name))
    try:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(prim_hit, name, fn)
    launches = _read_counts("fractal-spheres")
    finite = _check_image("[fractal-spheres]", r, img)
    segs = r.ray_counter.segments
    chunks = -(-r.width_ * r.height_ // (1 << 18))
    print(f"[fractal-spheres] {r.width_}x{r.height_} {r.num_samples_} spp {r.max_bounces_} "
          f"bounces, {sum(counts)} prims (spheres, cubes, planes, monomials = {counts}), "
          f"{len(compiled.lights)} lights, {chunks} chunks: wall {wall:.3f} s on {smi}, {segs} "
          f"ray segments, {segs / wall / 1e6:.3f} Mrays/s; image mean {img.mean():.4f} "
          f"(radiance {r._last_buffer.raw().mean():.5f}), finite and non-black {finite}; "
          f"launches {launches}; per-type prim calls {plain_calls}")
    if launches["prim_any_hit"] <= 0 or any(plain_calls.values()) or _other_launches(launches):
        raise RuntimeError(f"the fractal did not go through K-prim alone: launches {launches}, "
                           f"per-type calls {plain_calls}")
    return r


def phase_prim(r_fractal):
    """K-prim against its plain version on the card, on wavefronts captured
    from the renders' own passes (sample 0): the fractal's camera chunk
    (262,144 lanes x 938 prims) and its shadow wavefront, a marbles bounce
    (25 spheres and the monomial glass, level 1 of the first chunk), a
    volumetric lampshade level (its six cubes) and the `monomial_glass`
    camera chunk (every prim type), each to `PRIM_AGREEMENT`,
    `PRIM_RTOL` and `PRIM_ATOL`, with its bit-equal lanes, times and
    bound. First, on the card: torch's ``x ** 2`` against ``x * x`` (the
    kernel squares where the plain version calls pow). Returns the two
    entries of the kernel report."""
    import _torch_assets
    import torch_marbles
    import torch_monomial_glass
    import torch_volumetric_pathtrace_lampshade as lampshade

    x = torch.randn(1 << 20, device="cuda") * 100.0
    square = bool(_bit_equal(x ** 2, x * x).all())
    print(f"[K-prim] torch's x ** 2 rounds as x * x on the card: {square}")

    renders = {"fractal": r_fractal}
    state = torch_marbles.initial_state("cuda")
    renders["marbles"] = torch_marbles.renderer(
        "cuda", torch_marbles.marble_positions(state), _torch_assets.get_hdri("ballroom_8k"),
        sample=1)
    renders["lampshade"] = lampshade.renderer("cuda", sample=1, seed=0)
    renders["monomial_glass"] = torch_monomial_glass.renderer("cuda")
    calls = {name: _capture_calls(r, "prim_hit", K_PRIM) for name, r in renders.items()}
    closest_cases = (("fractal camera chunk", "fractal", 0), ("marbles level-1 bounce",
                                                              "marbles", 1),
                     ("volumetric lampshade level 0", "lampshade", 0),
                     ("monomial_glass camera chunk", "monomial_glass", 0))
    worst, ok, numbers = 1.0, True, {}
    for label, name, index in closest_cases:
        (prims, ray, t_min), _ = calls[name]["prim_closest_hit"][index]
        numbers[label], share, good = _prim_case(label, prims, ray, t_min)
        worst, ok = min(worst, share), ok and good
    (prims, ray, t_min, limit), _ = calls["fractal"]["prim_any_hit"][0]
    shadow, share = _prim_any_case("fractal shadow wavefront (chunk 0, two lights)", prims, ray,
                                   t_min, limit)
    worst = min(worst, share)
    if worst < PRIM_AGREEMENT or not ok:
        raise RuntimeError(f"K-prim agrees with its plain version on {worst:.6f} of lanes "
                           f"(< {PRIM_AGREEMENT}), or its time or normal differ where it agrees")

    camera = numbers["fractal camera chunk"]
    closest = {"name": "prim_closest_hit", "route": "cuda",
               "source": "rpt_tpu_torch/csrc/prim_hit.cu", "replaces": "rpt_tpu/intersect.py:832",
               "max_abs_err": max(v["max_abs_err"] for v in numbers.values()),
               **{k: camera[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               "library_ms": None, "bit_equal_lanes": camera["bit_equal_lanes"],
               "lanes": camera["lanes"]}
    for label, prefix in (("marbles level-1 bounce", "marbles_bounce"),
                          ("volumetric lampshade level 0", "lampshade_level"),
                          ("monomial_glass camera chunk", "monomial_glass")):
        closest.update(_side(prefix, numbers[label]),
                       **{f"{prefix}_bit_equal_lanes": numbers[label]["bit_equal_lanes"]})
    anyhit = {"name": "prim_any_hit", "route": "cuda", "source": "rpt_tpu_torch/csrc/prim_hit.cu",
              "replaces": "rpt_tpu/intersect.py:846", "max_abs_err": shadow["max_abs_err"],
              **{k: shadow[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
              "library_ms": None, "lanes": shadow["lanes"]}
    return [closest, anyhit]


# K-dense's float32 operations a (ray, triangle) pair, counted from
# `csrc/dense_tri_hit.cu` `slot_hit`: t (two dot products, a difference, a
# division: 14) and its tests (5), where a pair whose t fails them stops;
# past them the on-plane guard (3 abs, 3 adds, a product and a test: 8)
# and the barycentrics (the point and its offset 9, two dot products 10,
# two quotients 8, u 2, three tests 3). The table is read once a block, so
# the bytes are what each lane reads and writes, and the tables.
DENSE_T_OPS = 19
DENSE_PAIR_OPS = 59
DENSE_RAY_BYTES = 24


def _live(args) -> int:
    """The lanes of a captured any-hit call that test the mesh."""
    t_min, limit, skip = args[2:]
    return int(((torch.as_tensor(limit) > t_min) & ~skip).sum())


def _dense_ops(bvh, ray, t_min, bound, walking, any_hit: bool) -> int:
    """K-dense's float32 operations on a wavefront, pair by pair as its
    threads walk the slots: `DENSE_PAIR_OPS` for a pair whose t passes its
    tests, `DENSE_T_OPS` for one whose t fails them. Lanes in ``walking``
    test the mesh; a closest-hit lane's bound falls to each hit's t, an
    any-hit lane stops at its first hit. The chain's arithmetic decides."""
    from rpt_tpu_torch.ops.dense_tri_hit import _origin_on_plane
    from rpt_tpu_torch.vec import Vec3

    shape = ray.origin.x.shape
    comps = [torch.broadcast_to(getattr(v, c), shape).reshape(-1)
             for v in (ray.origin, ray.dir) for c in "xyz"]
    o, d = Vec3(*comps[:3]), Vec3(*comps[3:])
    bound = torch.broadcast_to(torch.as_tensor(bound, device=o.x.device), shape).reshape(-1)
    walking = walking.reshape(-1).clone()
    ops = 0
    for leaf in bvh.leaves:
        leaf = leaf.reshape(10, -1)
        for s in range(leaf.shape[1]):
            if leaf[9, s] < 0:
                continue
            v1, e1, e2 = (Vec3(*leaf[c:c + 3, s]) for c in (0, 3, 6))
            pn = e1.cross(e2).normalize()
            cosine, num = pn.dot(d), pn.dot(v1 - o)
            t = num / cosine
            passes = walking & (torch.abs(cosine) >= 1e-8) & (t >= t_min) & (t < bound)
            n_pass = int(passes.sum())
            ops += n_pass * DENSE_PAIR_OPS + (int(walking.sum()) - n_pass) * DENSE_T_OPS
            d2 = o + d * t - v1
            d00, d01, d11 = e1.dot(e1), e1.dot(e2), e2.dot(e2)
            d20, d21 = d2.dot(e1), d2.dot(e2)
            denom = d00 * d11 - d01 * d01
            v = (d11 * d20 - d01 * d21) / denom
            w = (d00 * d21 - d01 * d20) / denom
            u = 1.0 - v - w
            hit = (passes & ~_origin_on_plane(num, pn, v1, o)
                   & (u >= 0.0) & (v >= 0.0) & (w >= 0.0))
            if any_hit:
                walking &= ~hit
            else:
                bound = torch.where(hit, t, bound)
    return ops


def _dense_case(label: str, any_hit: bool, args) -> dict:
    """K-dense on one captured wavefront against the chain on the same
    tensors (`dense_tri_hit_plain`; for any hit its ``time < limit``, the
    ``skip`` lanes false): the bit-equal lanes, the kernel's device time
    (`_device_ms`) and the host's enqueue, the chain's time (CUDA events
    around one call) and the bound."""
    from rpt_tpu_torch.ops import dense_tri_hit as kd
    from rpt_tpu_torch.ops.dense_tri_hit import dense_tri_hit_plain

    bvh, ray, t_min = args[:3]
    n = ray.origin.x.numel()
    tris = int((bvh.leaves[:, 72:] >= 0).sum())
    tables = _nbytes(bvh.leaves, bvh.shade)
    if any_hit:
        limit, skip = args[3:]
        got = kd.dense_any_hit(*args)
        ref, plain_ms = _events_ms(lambda: kd.dense_any_hit_plain(*args))
        equal = got == ref
        live = (torch.as_tensor(limit) > t_min) & ~skip
        # every lane reads its limit and skip and writes its flag; a live
        # lane reads its ray
        n_bytes = n * (4 + 1 + 1) + int(live.sum()) * DENSE_RAY_BYTES + tables
        ops = _dense_ops(bvh, ray, t_min, limit, live, any_hit=True)
        bound_ms, bound_by = _bound(n_bytes, ops)
        detail = (f"{int((~live).sum())} gated off (skip or limit <= t_min), "
                  f"{float(ref.float().mean()):.4f} occluded")
        ms, enqueue = _device_ms(lambda: kd.dense_any_hit(*args))
    else:
        got = kd.dense_closest_hit(*args)
        ref, plain_ms = _events_ms(lambda: dense_tri_hit_plain(*args))
        equal = ((_bit_equal(got.time, ref.time) & (got.material == ref.material))
                 & _bit_equal(got.normal.x, ref.normal.x) & _bit_equal(got.normal.y, ref.normal.y)
                 & _bit_equal(got.normal.z, ref.normal.z))
        best = args[3]
        # every lane reads its ray and incoming time and writes a hit (20 B);
        # a lane the mesh does not improve reads the incoming normal and
        # material, the others the winner's shade row (the tables)
        kept = n - int((ref.time < best.time).sum())
        n_bytes = n * (DENSE_RAY_BYTES + 4 + 20) + kept * 16 + tables
        ops = _dense_ops(bvh, ray, t_min, best.time, torch.ones(n, dtype=torch.bool,
                                                                 device=ray.origin.x.device),
                         any_hit=False)
        bound_ms, bound_by = _bound(n_bytes, ops)
        detail = (f"{float((ref.time < best.time).float().mean()):.4f} nearer than the prims, "
                  f"{float(ref.valid.float().mean()):.4f} hit")
        ms, enqueue = _device_ms(lambda: kd.dense_closest_hit(*args))
    bits = int(equal.sum())
    print(f"[K-dense] {label}: {n} lanes x {tris} triangles in {bvh.leaves.shape[0]} rows "
          f"({detail}): bit-equal lanes {bits} of {n}; kernel {ms:.4f} ms on the device (host "
          f"enqueue {enqueue:.4f} ms), chain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {n_bytes} bytes, {ops} operations)")
    return {"ms": ms, "host_ms": enqueue, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bit_equal_lanes": bits, "lanes": n}


def phase_dense():
    """`[K-dense]`: the lampshade's 12 triangles (3 leaf rows) on the
    benchmark cells' own wavefronts, captured from one volumetric path
    pass (128^2, 1 spp: the camera level, a bounce level, the NEE shadow
    wavefront with the most live lanes, limit -1 on its gated ones) and
    one point-beam render at its example's parameters (1M photons, 1 spp:
    the shoot's first level, the camera pass's first closest-hit
    wavefront, the occlusion recheck with its `skip` mask), each bit for
    bit against the chain. Every call of both captures is replayed through
    both and must be bit-equal too. Returns the two entries of the kernel
    report: the path camera level (closest hit) and the recheck (any hit)
    with the others as side fields; their launches are the paths' own
    (`DENSE_LAUNCHES`), set by `main`."""
    from rpt_tpu_torch import Buffer
    from rpt_tpu_torch.ops import dense_tri_hit as kd
    from rpt_tpu_torch.ops.dense_tri_hit import dense_tri_hit_plain
    import torch_volumetric_beamphoton_lampshade as beam_ex
    import torch_volumetric_pathtrace_lampshade as path_ex

    path = path_ex.renderer("cuda", sample=1, seed=0)
    beam = beam_ex.renderer("cuda", sample=1, seed=0)
    path_calls, beam_calls = (
        {name: [args for args, _ in c] for name, c in _recording("dense", K_DENSE, run).items()}
        for run in (lambda: path.sample(1, Buffer(path.width_, path.height_, path.filter_)),
                    lambda: beam.photon_point_query_beam_render(beam_ex.photons)))
    every_call = 0
    for calls in (path_calls, beam_calls):
        for args in calls["dense_closest_hit"]:
            got, ref = kd.dense_closest_hit(*args), dense_tri_hit_plain(*args)
            every_call += int(not (bool(_bit_equal(got.time, ref.time).all())
                                   and torch.equal(got.material, ref.material)
                                   and all(bool(_bit_equal(getattr(got.normal, c),
                                                           getattr(ref.normal, c)).all())
                                           for c in "xyz")))
        for args in calls["dense_any_hit"]:
            every_call += int(not torch.equal(kd.dense_any_hit(*args),
                                              kd.dense_any_hit_plain(*args)))
    counts = {path: {name: len(c[name]) for name in K_DENSE}
              for path, c in (("pass", path_calls), ("render", beam_calls))}
    print(f"[K-dense] calls captured: a 128^2 volumetric path pass {counts['pass']}, a 1M-photon "
          f"point-beam render at 1 spp {counts['render']}; calls not bit-equal {every_call}")
    shoot = beam_calls["dense_closest_hit"][0]
    camera = next((a for a in beam_calls["dense_closest_hit"]
                   if a[1].origin.x.numel() == beam.width_ * beam.height_),
                  beam_calls["dense_closest_hit"][-1])
    recheck = max(beam_calls["dense_any_hit"], key=lambda a: a[1].origin.x.numel())
    cases = {"path camera level": (False, path_calls["dense_closest_hit"][0]),
             "path bounce level": (False, path_calls["dense_closest_hit"][1]),
             "path shadow wavefront": (True, max(path_calls["dense_any_hit"], key=_live)),
             "photon shoot level 0": (False, shoot),
             "beam camera wavefront": (False, camera),
             "beam occlusion recheck": (True, recheck)}
    numbers = {label: _dense_case(label, any_hit, args)
               for label, (any_hit, args) in cases.items()}
    worst = min(v["bit_equal_lanes"] / v["lanes"] for v in numbers.values())
    if every_call or worst < 1.0:
        raise RuntimeError(f"K-dense differs from the chain: {every_call} calls, worst case "
                           f"{worst:.6f} of lanes bit-equal")
    entries = []
    for name, main, sides, source in (
            ("dense_closest_hit", "path camera level",
             (("path_bounce", "path bounce level"), ("shoot", "photon shoot level 0"),
              ("beam_camera", "beam camera wavefront")), "rpt_tpu/intersect.py:652"),
            ("dense_any_hit", "beam occlusion recheck",
             (("path_shadow", "path shadow wavefront"),), "rpt_tpu/intersect.py:767")):
        entry = {"name": name, "route": "cuda", "source": "rpt_tpu_torch/csrc/dense_tri_hit.cu",
                 "replaces": source, "max_abs_err": 0.0, "library_ms": None,
                 **{k: numbers[main][k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                                  "bound_by", "bit_equal_lanes", "lanes")}}
        for prefix, label in sides:
            entry.update(_side(prefix, numbers[label]),
                         **{f"{prefix}_lanes": numbers[label]["lanes"]})
        entries.append(entry)
    return entries


# K-shoot's bytes a lane: its ray (24), power (12), key row (16) and hit
# (time, normal, material: 20) in; out, a survivor's ray, power and key row
# (52) and a deposit row (48). Its hashes, counted from
# `csrc/photon_shoot.cu` `interact`: the level's fold; in a medium, the
# free flight's two folds and draw; a volume event's roulette (a fold, a
# draw) and phase (two folds, two draws); a surface event's roulette (a
# fold, a draw) and lobe (three folds, three draws).
SHOOT_IN_BYTES, SHOOT_SURVIVOR_BYTES, SHOOT_ROW_BYTES = 72, 52, 48
SHOOT_HASHES = {"level": 1, "flight": 3, "volume": 6, "surface": 8}
# the skybox shoot's late level timed beside level 0
SHOOT_LATE_LEVEL = 12


def _shoot_case(label: str, chunk, hit, medium, mats) -> dict:
    """K-shoot on the chunk's next level against `shoot_level_plain` on the
    same state and hit: the level's deposit rows and the survivors bit for
    bit, K-shoot's device time (its three kernels, `_device_ms`; a call
    rewrites the same outputs) and the host's enqueue, the wall of the
    whole `shoot_level` (enqueue and the survivors' read), the chain's time
    and the bound. Runs the level."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.ops import photon_shoot as ks

    level, n = chunk.level, chunk.lanes
    ray, power, keys = chunk.ray(), chunk.power(), sampling.key_path(chunk.keys().clone())

    def plain():
        return ks.shoot_level_plain(ray, power, keys, hit, level, medium, mats)

    plain()  # a warm-up: the chain's first call in a process loads its kernels
    (s, v, ray_p, power_p, keys_p), plain_ms = _events_ms(plain)
    ms, enqueue = _device_ms(lambda: ks._launch(chunk, hit, level))
    s_off, v_off = chunk.offsets[level, :2].tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ks.shoot_level(chunk, hit, level)
    wall_ms = (time.perf_counter() - t0) * 1e3
    s_end, v_end = chunk.offsets[level + 1, :2].tolist()
    got = chunk.ray()
    equal = (torch.equal(chunk.surface[s_off:s_end], s)
             and torch.equal(chunk.volume[v_off:v_end], v)
             and all(torch.equal(getattr(a, c), getattr(b, c)) for a, b in
                     ((got.origin, ray_p.origin), (got.dir, ray_p.dir), (chunk.power(), power_p))
                     for c in "xyz")
             and torch.equal(chunk.keys(), keys_p.base))
    survivors, rows = chunk.lanes, s.shape[0] + v.shape[0]
    valid = int(hit.valid.sum())
    hashes = (n * (SHOOT_HASHES["level"] + (SHOOT_HASHES["flight"] if medium is not None else 0))
              + v.shape[0] * SHOOT_HASHES["volume"]
              + max(0, valid - v.shape[0]) * SHOOT_HASHES["surface"])
    n_bytes = n * SHOOT_IN_BYTES + survivors * SHOOT_SURVIVOR_BYTES + rows * SHOOT_ROW_BYTES
    bound_ms, bound_by = max(_bound(n_bytes, 0), _bound(0, hashes * HASH_OPS, INT32_OPS_PER_S))
    print(f"[K-shoot] {label}: {n} lanes ({s.shape[0]} surface, {v.shape[0]} volume deposits, "
          f"{survivors} survivors): bit-equal {equal}; kernel {ms:.4f} ms on the device (host "
          f"enqueue {enqueue:.4f} ms, the level's call with its read {wall_ms:.4f} ms), chain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}: {n_bytes} bytes, {hashes} "
          f"hashes)")
    return {"ms": ms, "host_ms": enqueue, "wall_ms": wall_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bit_equal": equal, "lanes": n}


def phase_shoot():
    """`[K-shoot]`: the skybox shoot's first chunk (500,000 photons of its
    10M, `examples/torch_skybox_photons.py`), level by level through
    K-shoot, with level 0 and level `SHOOT_LATE_LEVEL` timed and held bit
    for bit to the chain (`_shoot_case`). Its launches a render are the
    skybox render's (`phase_skybox_photons`) and the point-beam
    lampshade's (`phase_render`), as `_read_shoot` recorded them. Returns
    the kernel report's entry."""
    from rpt_tpu_torch import sampling
    from rpt_tpu_torch.integrators import photon as ph
    from rpt_tpu_torch.intersect import closest_hit
    from rpt_tpu_torch.ops import photon_shoot as ks
    import torch_skybox_photons as sky_ex

    r = sky_ex.renderer("cuda")
    scene, tables = r.compiled, r.compiled.tables
    medium, mats = scene.media[0], tables["materials"]
    li, _ = ph._find_object_light(scene)
    chunk_n = 1 << 19
    nchunks = -(-sky_ex.PHOTONS // chunk_n)
    n = -(-sky_ex.PHOTONS // nchunks)
    key = sampling.fold_in(sampling.key(r.seed_, "cuda"), 1)
    ray, power, keys = ph._emit(scene, tables, li, r.watts_ / (nchunks * n), n,
                                sampling.fold_in(key, 0))
    chunk = ks.ShootChunk(ray, power, keys.base, mats, medium, 48, 4 * n, 10 * n)
    cases = {}
    while chunk.lanes:
        hit = closest_hit(scene, tables, chunk.ray())
        level = chunk.level
        if level in (0, SHOOT_LATE_LEVEL):
            cases[level] = _shoot_case(f"skybox shoot level {level}", chunk, hit, medium, mats)
        else:
            ks.shoot_level(chunk, hit, chunk.level)
    late = cases.get(SHOOT_LATE_LEVEL, cases[0])
    if not all(c["bit_equal"] for c in cases.values()):
        raise RuntimeError(f"K-shoot differs from the chain: {cases}")
    sky, beam = (SHOOT_LAUNCHES[path]["shoot_level"] for path in ("skybox-photons", "render"))
    print(f"[K-shoot] calls a render: {sky} in the {sky_ex.PHOTONS}-photon skybox render, {beam} "
          f"in the point-beam lampshade's; by path {SHOOT_LAUNCHES}")
    return {"name": "shoot_level", "route": "cuda", "source": "rpt_tpu_torch/csrc/photon_shoot.cu",
            "replaces": "rpt_tpu/integrators/photon.py:137", "max_abs_err": 0.0,
            "library_ms": None,
            **{k: cases[0][k] for k in ("ms", "host_ms", "wall_ms", "plain_ms", "bound_ms",
                                        "bound_by", "lanes")},
            **_side("late", late), "late_lanes": late["lanes"], "late_level": SHOOT_LATE_LEVEL,
            "launches": sky, "beam_launches": beam, "launches_by_path": dict(SHOOT_LAUNCHES)}


# K-estimate's bytes, counted from `csrc/photon_estimate.cu`: a lane's ray,
# hit time and key row with its data word in and its queries and flight
# out (prep), its direction, hit, flight and material in and its colour
# out (finish); a pair of the surface gather's answer and its photon's
# position in and its recheck ray out (pairs); an answer of the branch a
# lane takes, its distance, index, photon direction and power and its
# recheck's answer (finish).
ESTIMATE_LANE_BYTES, ESTIMATE_PAIR_BYTES, ESTIMATE_ANSWER_BYTES = 128, 52, 37


def _kernel_ms(fn, names, reps: int = 5) -> dict:
    """Mean device milliseconds a call of ``fn`` of each kernel whose name
    holds one of ``names``, from `torch.profiler` (CUDA activity), over
    ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total = dict.fromkeys(names, 0.0)
    for e in prof.profiler.kineto_results.events():
        for name in names:
            if e.device_type() == cuda and name in e.name():
                total[name] += e.duration_ns() / 1e6
    return {name: t / reps for name, t in total.items()}


def _estimate_case(label: str, r, lanes: int, point: bool) -> dict:
    """K-estimate on the first ``lanes`` lanes of sample 0's camera
    wavefront of the photon render ``r`` (its map and gather sizes),
    against the chain on the same tensors: the colour bit for bit; the
    three kernels' device time (`_kernel_ms`), the whole estimate's wall
    time (its gathers and recheck included) by the kernel and by the chain
    (the host waits for the card after each), K-knn's device time inside,
    and the bound of K-estimate's bytes."""
    from rpt_tpu_torch import intersect, sampling
    from rpt_tpu_torch.integrators import photon as ph
    from rpt_tpu_torch.ops import photon_estimate as pe
    from rpt_tpu_torch.ray import Ray

    scene, pmap = r.compiled, r.photon_map
    full, ekeys, _ = _sample0(r)
    sl = slice(0, lanes)
    ray, keys = Ray(full.origin[sl], full.dir[sl]), ekeys[sl]
    hit = intersect.closest_hit(scene, scene.tables, ray)
    k, kv = r.gather_size_, r.gather_size_volume_
    common = (ph.knn_query, intersect.occluded)
    if point:
        medium = scene.media[0]
        args = (scene, scene.tables, pmap, medium, ray, hit, keys, k, kv, True, *common)
        kernel, chain = (lambda: pe.point(*args)), (lambda: pe.point_plain(*args))
        d, _, _ = medium.sample_d(ray, sampling.key_path(keys).fold(pe.FLIGHT_TAG))
        in_volume = ~hit.valid | (d < hit.time)
    else:
        args = (scene, scene.tables, pmap, ray, hit, k, True, *common)
        kernel, chain = (lambda: pe.surface(*args)), (lambda: pe.surface_plain(*args))
        in_volume = torch.zeros_like(hit.valid)
    got, want = kernel().to_array(), chain().to_array()
    equal = torch.equal(got, want)
    chain()  # a warm-up: the chain's first call in a process loads its kernels
    _, plain_ms = _events_ms(chain)
    _, wall_ms = _events_ms(kernel)
    times = _kernel_ms(kernel, (*(f"{n}_kernel" for n in K_ESTIMATE), "knn_query_kernel"))
    ms = sum(times[f"{n}_kernel"] for n in K_ESTIMATE)
    n_vol = int(in_volume.sum())
    answers = n_vol * kv + int((hit.valid & ~in_volume).sum()) * k
    n_bytes = (lanes * ESTIMATE_LANE_BYTES + lanes * k * ESTIMATE_PAIR_BYTES
               + answers * ESTIMATE_ANSWER_BYTES)
    bound_ms, bound_by = _bound(n_bytes, 0)
    print(f"[K-estimate] {label}: {lanes} lanes ({n_vol} in the medium, "
          f"{int((~hit.valid).sum())} missing), k = {k}{f' / {kv}' if point else ''}: "
          f"bit-equal {equal}; kernels "
          f"{ms:.4f} ms on the device ({', '.join(f'{n} {t:.4f}' for n, t in times.items())}), "
          f"the estimate's wall {wall_ms:.3f} ms against the chain's {plain_ms:.3f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} bytes), {ms / bound_ms:.1f}x")
    if not equal:
        raise RuntimeError(f"K-estimate differs from the chain on {label}: "
                           f"{int((got != want).any(dim=1).sum())} lanes")
    return {"ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "lanes": lanes, "knn_ms": times["knn_query_kernel"],
            "kernels_ms": {n: times[f"{n}_kernel"] for n in K_ESTIMATE}}


def phase_estimate(r_sky, r_beam):
    """`[K-estimate]`: the point query of the skybox render (its first
    16,384-lane wavefront, k = 50 / 50) and the surface estimate of the
    point-beam lampshade render (its 16,384-lane wavefront, k = 20), each
    through K-estimate and the chain (`_estimate_case`). Its launches a
    render are those renders' own, as `_read_estimate` recorded them.
    Returns the kernel report's entry."""
    from rpt_tpu_torch.renderer import PIXEL_CHUNK

    sky = _estimate_case("skybox wavefront", r_sky, PIXEL_CHUNK, point=True)
    beam = _estimate_case("point-beam wavefront", r_beam,
                          min(PIXEL_CHUNK, r_beam.width_ * r_beam.height_), point=False)
    launches, beam_launches = (ESTIMATE_LAUNCHES[path]["estimate_finish"]
                               for path in ("skybox-photons", "render"))
    print(f"[K-estimate] calls a render: {launches} in the skybox render, {beam_launches} in the "
          f"point-beam lampshade's; by path {ESTIMATE_LAUNCHES}")
    return {"name": "photon_estimate", "route": "cuda",
            "source": "rpt_tpu_torch/csrc/photon_estimate.cu",
            "replaces": "rpt_tpu/integrators/photon.py:571", "max_abs_err": 0.0,
            "library_ms": None,
            **{key: sky[key] for key in ("ms", "wall_ms", "plain_ms", "bound_ms", "bound_by",
                                         "lanes", "knn_ms", "kernels_ms")},
            **_side("beam", beam), "beam_wall_ms": beam["wall_ms"], "beam_lanes": beam["lanes"],
            "launches": launches, "beam_launches": beam_launches,
            "launches_by_path": dict(ESTIMATE_LAUNCHES)}


def main():
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU")
    parser.add_argument("--spp", type=int, default=None,
                        help="cap on the camera samples of the four full-size photon renders "
                             "and the pegasus (their examples' 50, 100, 10, 50 and 10 when left "
                             "out) and of the two marbles frames (16 when left out; the "
                             "example's 2000 would take minutes a frame)")
    parser.add_argument("--vol-spp", type=int, default=40,
                        help="camera samples of the volumetric path render (the example's 1000 "
                             "would take about half an hour)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; nothing was run")
    sys.path.insert(0, ROOT)

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rng = phase_rng()
    r, ex, launches = phase_render(args.spp)
    kernels = [phase_sweep(r, ex), phase_knn(r)]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    kernels[1]["radius_launches"] = launches["knn_radius"]
    phase_golden(ex)
    phase_rng_renders(ex)
    r_dragon, path_launches = phase_dragon()
    traverse = phase_traverse(r_dragon)
    for k in traverse:
        k["launches"] = path_launches[k["name"]]
    kernels += traverse
    phase_golden_path()
    sharded = phase_sharded(r_dragon, r)
    for k in kernels:
        k["sharded_launches"] = sharded[k["name"]]
    del r_dragon
    r_pegasus, pegasus_launches = phase_pegasus(args.spp)
    pegasus = phase_pegasus_wavefronts(r_pegasus)
    del r_pegasus
    teapot_launches, teapot_k1, teapot_k2 = phase_teapot()
    # the slice's numbers ride as side fields of the dragon's K1/K2 entries
    k1, k2 = traverse
    k1.update(pegasus_launches=pegasus_launches["bvh_closest_hit"],
              **_side("pegasus", pegasus["camera"]),
              **_side("pegasus_bounce", pegasus["level-1 bounce"]),
              teapot_launches=teapot_launches["bvh_closest_hit"], **_side("teapot", teapot_k1))
    k2.update(pegasus_launches=pegasus_launches["bvh_any_hit"],
              **_side("pegasus_sun_shadow", pegasus["shadow"]),
              teapot_launches=teapot_launches["bvh_any_hit"], **_side("teapot", teapot_k2))
    for k, numbers in ((k1, (pegasus["camera"], pegasus["level-1 bounce"],
                             pegasus["level-2 bounce"], teapot_k1)),
                       (k2, (pegasus["shadow"], teapot_k2))):
        k["max_abs_err"] = max(k["max_abs_err"], *(n["max_abs_err"] for n in numbers))
    phase_marbles(args.spp)
    prim = phase_prim(phase_fractal(smi))
    lampshade, lampshade_by_k = phase_photonmap(args.spp)
    default, default_by_k = phase_photonmap_default(args.spp)
    # one entry a main path's gather, its launches that path's at its k;
    # the gathers at a k no path takes (64, 128) and k = 50 on the
    # lampshade's queries ride as side fields of the entry of their list
    kernels.append(_knn_entry(50, "photonmap-default", default_by_k[50],
                              {**default, **_beside("lampshade", lampshade[50]),
                               **_beside("k64_lampshade", lampshade[64])}))
    kernels.append(_knn_entry(100, "photonmap", lampshade_by_k[100],
                              {**lampshade[100], **_beside("k128", lampshade[128])}))
    kernels.append(_knn_entry(30, "photonmap", lampshade_by_k[30], lampshade[30]))
    # the volume gather at k = 50 is an entry of its own; the surface gather
    # of the same path rides as its side fields
    sky_volume, sky_surface, sky_launches, r_sky = phase_skybox_photons(args.spp)
    estimate = phase_estimate(r_sky, r)
    del r_sky
    kernels.append({**_knn_entry(50, "skybox-photons", sky_launches,
                                 {**sky_volume, **_beside("surface", sky_surface)}),
                    "name": "knn_query_k50_volume", "surface_launches": sky_launches})
    kernels[1]["beambeam_launches"] = phase_beambeam(args.spp)
    phase_directional_sweep(r)
    phase_volpath(args.vol_spp)
    dense = phase_dense()
    shoot = phase_shoot()
    phase_golden_media()
    drivers = phase_drivers()
    k1["drivers_launches"], k2["drivers_launches"] = (drivers["bvh_closest_hit"],
                                                      drivers["bvh_any_hit"])
    kernels += _rng_entries(rng)
    # K-prim's launches: the fractal's, the path it was brought up for, and
    # every path's beside them
    for k in prim:
        by_path = {path: counts[k["name"]] for path, counts in PRIM_LAUNCHES.items()}
        k.update(launches=by_path["fractal-spheres"], launches_by_path=by_path)
    kernels += prim
    # K-dense's launches: the volumetric path's and the point-beam render's,
    # the two benchmark cells' paths, and every path's beside them
    for k in dense:
        by_path = {path: counts[k["name"]] for path, counts in DENSE_LAUNCHES.items()}
        k.update(launches=by_path["volpath"], render_launches=by_path["render"],
                 launches_by_path=by_path)
    kernels += dense
    kernels.append(shoot)
    kernels.append(estimate)
    print(f"[K-rng] launches by path: {RNG_LAUNCHES}")
    print(f"[K-prim] launches by path: {PRIM_LAUNCHES}")
    print(f"[K-dense] launches by path: {DENSE_LAUNCHES}")
    print(f"[K-shoot] launches by path: {SHOOT_LAUNCHES}")
    print(f"[K-estimate] launches by path: {ESTIMATE_LAUNCHES}")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
