"""Renderer: the chainable front end, the path-tracing launches and
the photon-mapping camera pass — port of `rpt_tpu/renderer.py`
(`rpt/src/renderer.rs:23-184`).

Same fields and defaults as the reference (renderer.rs:60-75), plus a
``device``, ``"cuda"`` unless the caller asks for ``"cpu"``:
``Renderer(scene, camera)`` raises where CUDA is absent; it never carries
on on the CPU. Both passes trace
one wavefront per pixel sample in a Python loop over absolute sample
indices, so per-sample RNG streams match the JAX package's.

All four integrators run: path tracing (``render``, ``sample``,
``iterative_render``) through `integrators.path.trace_surface`, or
`trace_volumetric` where the scene has a medium, and the three photon
kinds (``photon_map_render``, ``photon_point_query_beam_render``,
``photon_beam_query_beam_render``) through `integrators.photon`.

``profile(trace_dir)`` records the next ``sample`` or ``photon_render``
call under ``torch.profiler``, with the program's spans (`tracing`) on a
track of their own; ``RPT_TPU_PREVIEW`` shrinks a render for smoke runs
(`_apply_preview`), as in the JAX package. The multi-device passes are
`rpt_tpu_torch.parallel`'s.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import sampling, tracing
from .buffer import Buffer, Filter
from .camera import Camera
from .dtypes import DTYPE, resolve_device
from .ray import Ray
from .scene import CompiledScene, Scene

PIXEL_CHUNK = 16384  # lanes per estimate wavefront (bounds peak memory)
PATH_CHUNK = 1 << 18  # lanes per path-tracing wavefront (a 512^2 sample is one)


@dataclass
class Renderer:
    """Builder object (renderer.rs:23-134). Chainable setters return self
    for reference-style call chains."""

    scene: Scene
    camera: Camera
    width_: int = 800
    height_: int = 600
    exposure_value_: float = 0.0
    filter_: Filter = Filter()
    stepsize_: float = 0.0
    max_bounces_: int = 0
    num_samples_: int = 1
    gather_size_: int = 50
    gather_size_volume_: int = 50
    watts_: float = 100.0
    seed_: int = 0
    media_max_depth_: int = 32
    device: object = field(default="cuda", kw_only=True)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._compiled: CompiledScene | None = None
        self._sample_index = 0
        self.ray_counter = RayCounter()
        self.phase_seconds: dict = {}
        self.photon_counts: dict = {}
        self.photon_map = None
        self._profile_dir = None

    # builder setters ----------------------------------------------------
    def width(self, v):
        self.width_ = int(v)
        return self

    def height(self, v):
        self.height_ = int(v)
        return self

    def exposure_value(self, v):
        self.exposure_value_ = float(v)
        return self

    def filter(self, f: Filter):
        self.filter_ = f
        return self

    def stepsize(self, v):
        self.stepsize_ = float(v)
        return self

    def max_bounces(self, v):
        self.max_bounces_ = int(v)
        return self

    def num_samples(self, v):
        self.num_samples_ = int(v)
        return self

    def gather_size(self, v):
        self.gather_size_ = int(v)
        return self

    def gather_size_volume(self, v):
        self.gather_size_volume_ = int(v)
        return self

    def watts(self, v):
        self.watts_ = float(v)
        return self

    def seed(self, v):
        self.seed_ = int(v)
        return self

    def media_max_depth(self, v):
        self.media_max_depth_ = int(v)
        return self

    def profile(self, trace_dir: str):
        """Record the next ``sample`` or ``photon_render`` call (one-shot)
        under ``torch.profiler``, the CPU and, on the card, its kernels, and
        write a Chrome trace into ``trace_dir`` (`rpt_tpu/renderer.py:114-120`;
        the reference has no profiler). The call's spans (`tracing`) go
        into the trace as complete events on a track of their own, on the
        profiler's time base, so each idle gap of the card lies under the
        span the host was in. The image is unchanged."""
        self._profile_dir = trace_dir
        return self

    # ------------------------------------------------------------------
    @property
    def compiled(self) -> CompiledScene:
        if self._compiled is None:
            self._compiled = self.scene.compile(self.device)
        return self._compiled

    def _apply_preview(self):
        """RPT_TPU_PREVIEW=<s> shrinks a render for smoke runs without
        touching driver code (`rpt_tpu/renderer.py:129-140`): the width
        and height divided by s (at least 8), the samples capped at
        RPT_TPU_PREVIEW_SAMPLES (4); `photon_render` caps the photons at
        RPT_TPU_PREVIEW_PHOTONS (5000). The device stays the caller's."""
        scale = os.environ.get("RPT_TPU_PREVIEW")
        if scale:
            s = max(1, int(scale))
            self.width_ = max(8, self.width_ // s)
            self.height_ = max(8, self.height_ // s)
            cap = int(os.environ.get("RPT_TPU_PREVIEW_SAMPLES", "4"))
            self.num_samples_ = max(1, min(self.num_samples_, cap))

    def render(self) -> np.ndarray:
        """Path trace and return an (H, W, 3) sRGB u8 image
        (renderer.rs:137-141)."""
        self._apply_preview()
        buffer = Buffer(self.width_, self.height_, self.filter_)
        self.sample(self.num_samples_, buffer)
        self._last_buffer = buffer
        return buffer.image()

    def iterative_render(self, callback_interval: int, callback) -> Buffer:
        """Progressive render; ``callback(iteration, buffer)`` every
        ``callback_interval`` samples (renderer.rs:144-156)."""
        self._apply_preview()
        callback_interval = min(callback_interval, self.num_samples_)
        buffer = Buffer(self.width_, self.height_, self.filter_)
        iteration = 0
        while iteration < self.num_samples_:
            steps = min(self.num_samples_ - iteration, callback_interval)
            self.sample(steps, buffer)
            iteration += steps
            callback(iteration, buffer)
        return buffer

    def sample(self, iterations: int, buffer: Buffer):
        """Trace ``iterations`` paths per pixel and add ONE sample (their
        mean, exposure-scaled) to the buffer (renderer.rs:158-184). Sample
        indices are absolute across calls, as in the JAX package."""
        scene = self.compiled
        profile_dir, self._profile_dir = self._profile_dir, None
        with self._recording(profile_dir) as prof, tracing.span("sample") as root:
            t0 = time.perf_counter()
            total, segments = _path_pass(scene, self.camera, self.width_, self.height_,
                                         sampling.key(self.seed_, self.device),
                                         self._sample_index, int(iterations), self.max_bounces_,
                                         self.media_max_depth_)
            self.ray_counter.record(time.perf_counter() - t0, segments)
            mean = total / iterations * (2.0**self.exposure_value_)
            with tracing.span("frontend.accumulate"):
                buffer.add_samples(mean.reshape(self.height_, self.width_, 3))
        if profile_dir:
            self._write_trace(prof, root.request, profile_dir, f"sample_{self._sample_index}")
        self._sample_index += iterations

    def _write_trace(self, prof, request: int, profile_dir: str, stem: str):
        """The profile's Chrome trace ``<stem>.trace.json``, with the spans
        of ``request`` added."""
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"{stem}.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        mine = [s for s in tracing.spans() if s.request == request]
        trace["traceEvents"] += tracing.chrome_events(mine, trace.get("baseTimeNanoseconds", 0),
                                                      os.getpid())
        with open(path, "w") as f:
            json.dump(trace, f)

    # ------------------------------------------------------------------
    # Photon mapping (photon.rs:642-720)

    def photon_map_render(self, photon_count: int) -> np.ndarray:
        """Point-photon / point-query photon mapping (photon.rs:650-652)."""
        return self.photon_render(photon_count, "photon_map")

    def photon_point_query_beam_render(self, photon_count: int) -> np.ndarray:
        """Point-photon / beam-query (photon.rs:642-644)."""
        return self.photon_render(photon_count, "point_beam")

    def photon_beam_query_beam_render(self, photon_count: int) -> np.ndarray:
        """Beam-photon / beam-query (photon.rs:646-648)."""
        return self.photon_render(photon_count, "beam_beam")

    def _recording(self, profile_dir):
        """A ``torch.profiler.profile`` of the CPU and, on the card, of
        CUDA where ``profile_dir`` is set, else a context that records
        nothing."""
        if not profile_dir:
            return contextlib.nullcontext()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _phase(self, name: str, seconds: dict, lanes=None):
        """A phase of `photon_render`: ``seconds[name]`` is the host time
        from its start to the device sync at its end, and the span
        ``photon.<name>`` (with ``lanes``, a count the host holds) encloses
        both readings."""
        with tracing.span(f"photon.{name}", lanes):
            t0 = time.perf_counter()
            yield
            self._sync()
            seconds[name] = time.perf_counter() - t0

    def photon_render(self, photon_count: int, kind: str,
                      occlusion_check: bool = True) -> np.ndarray:
        """Shoot, build the map, run the camera pass; returns the (H, W, 3)
        sRGB u8 image. Keys as the JAX package: ``fold_in(key, 1)`` for
        the shoot, ``fold_in(key, 2)`` for the camera pass, and the host
        generator ``default_rng(seed + 17)`` for the beam-beam kind's
        thinning. Records ``phase_seconds`` (shoot/build/trace),
        ``photon_counts`` and the built ``photon_map``."""
        from .integrators import photon as ph

        self._apply_preview()
        if os.environ.get("RPT_TPU_PREVIEW"):  # `rpt_tpu/renderer.py:219-221`
            photon_count = min(photon_count,
                               int(os.environ.get("RPT_TPU_PREVIEW_PHOTONS", "5000")))
        scene = self.compiled
        key = sampling.key(self.seed_, self.device)
        seconds = {}
        profile_dir, self._profile_dir = self._profile_dir, None
        with self._recording(profile_dir) as prof, tracing.span("photon_render") as root:
            print("Shooting photons")
            with self._phase("shoot", seconds):
                photons = ph.shoot_photons_device(
                    scene, scene.tables, sampling.fold_in(key, 1), photon_count, self.watts_
                )
            n_s, n_v = photons.surface.shape[0], photons.volume.shape[0]
            print(f"PhotonList(surface: {n_s}, volume: {n_v})")
            self.photon_counts = {"surface": n_s, "volume": n_v, "dropped": photons.dropped}

            print("Building photon maps")
            with self._phase("build", seconds, n_s + n_v):  # the deposits it sorts
                pmap = ph.build_photon_map(scene, scene.tables, photons.surface, photons.volume,
                                           kind, self.gather_size_, self.gather_size_volume_,
                                           np.random.default_rng(self.seed_ + 17))
            self.photon_map = pmap

            print("Tracing rays")
            with self._phase("trace", seconds):
                total = _photon_pass(scene, self.camera, self.width_, self.height_, pmap,
                                     sampling.fold_in(key, 2), self.num_samples_,
                                     self.gather_size_, self.gather_size_volume_, occlusion_check)
            self.phase_seconds = seconds
            print(f"photon phases: shoot {seconds['shoot']:.1f}s build {seconds['build']:.1f}s "
                  f"trace {seconds['trace']:.1f}s")

            mean = total / self.num_samples_ * (2.0**self.exposure_value_)
            buffer = Buffer(self.width_, self.height_, self.filter_)
            with tracing.span("frontend.accumulate"):
                buffer.add_samples(mean.reshape(self.height_, self.width_, 3))
        if profile_dir:
            self._write_trace(prof, root.request, profile_dir, f"photon_render_{kind}")
        self._last_buffer = buffer
        return buffer.image()


class RayCounter:
    """The ray segments `trace_surface` or `trace_volumetric` traced
    (camera or bounce, and shadow; counted on the card), and the host
    seconds of the passes that traced them (`rpt_tpu/renderer.py:293`; the
    reference has none)."""

    def __init__(self):
        self.segments = 0
        self.seconds = 0.0

    def record(self, elapsed: float, segments: int):
        self.segments += int(segments)
        self.seconds += elapsed


def _morton2(px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Interleave 16-bit pixel coords -> 32-bit Morton codes."""

    def expand(v):
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    return (expand(py.astype(np.uint32)) << np.uint32(1)) | expand(px.astype(np.uint32))


def _pixel_grid(width: int, height: int):
    """Pixel NDC coordinates in Morton order (`rpt_tpu/renderer.py:329`).
    Per-pixel RNG streams fold by pixel id, so the image does not depend
    on the lane order; the order is kept so both packages trace the same
    wavefronts. Returns (xn, yn, pixel_ids, inv) with inv[pixel] = lane."""
    n_pix = width * height
    xs = np.arange(n_pix, dtype=np.int64)
    px = xs % width
    py = xs // width
    perm = np.argsort(_morton2(px, py), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = xs
    dim = float(max(width, height))
    # NDC mapping (renderer.rs:174-176): y flipped, aspect via max(w, h)
    xn = (2.0 * px[perm].astype(np.float64) + 1.0 - width) / dim
    yn = (2.0 * (height - py[perm]).astype(np.float64) - 1.0 - height) / dim
    return xn, yn, perm, inv


def camera_wavefront(scene, camera: Camera, width: int, height: int, key, s: int):
    """Sample ``s``'s camera wavefront in Morton lane order and its
    per-lane keys (`camera_rays`). Returns ``(ray, keys)``."""
    with tracing.span("frontend.camera"):
        xn_np, yn_np, pixel_ids, _ = _pixel_grid(width, height)
        return camera_rays(scene, camera, float(max(width, height)), xn_np, yn_np, pixel_ids,
                           key, s)


def camera_rays(scene, camera: Camera, dim: float, xn_np, yn_np, pixel_ids, key, s: int):
    """The camera rays of sample ``s`` through the pixels ``pixel_ids`` at
    NDC ``(xn_np, yn_np)`` (float64 arrays, rounded to float32 here), and
    their per-lane keys ``fold(fold_in(key, pixel_id), s)`` (the absolute
    sample index): jitter from folds 1 and 2, the lens from fold 3, the
    trace from fold 4 (`rpt_tpu/renderer.py:370-379`). ``dim`` is
    ``max(width, height)``. The keys stay a `sampling.KeyPath` (the key
    and the pixel ids, tag ``s`` pending); the jitter is drawn from it in
    one launch, the lens in another. Returns ``(ray, keys)``."""
    dev = scene.device
    xn = torch.tensor(xn_np, dtype=DTYPE, device=dev)
    yn = torch.tensor(yn_np, dtype=DTYPE, device=dev)
    keys = sampling.key_path(key, torch.tensor(pixel_ids, device=dev)).fold(s)
    jx, jy = sampling.draw(keys, sampling.Draw((1,), 1, -1.0 / dim, 1.0 / dim),
                           sampling.Draw((2,), 1, -1.0 / dim, 1.0 / dim))
    return camera.cast_ray(xn + jx, yn + jy, keys.fold(3)), keys


def _path_pass(scene, camera: Camera, width: int, height: int, key, s0: int, n_samples: int,
               max_bounces: int, media_max_depth: int = 32):
    """The per-sample launch of `rpt_tpu/renderer.py::build_launch`: for
    each absolute sample index s0..s0+n_samples-1, one camera wavefront
    traced in PATH_CHUNK-lane pieces (per-pixel keys make the image
    independent of the chunking) by `trace_volumetric` with
    ``media_max_depth`` levels where the scene has a medium, else by
    `trace_surface` with ``max_bounces``, summed in float32. Returns the
    (H*W, 3) radiance sum in raster order (f64) and the number of traced
    ray segments."""
    from .integrators.path import trace_surface, trace_volumetric

    dev = scene.device
    n_pix = width * height
    total = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(s0, s0 + n_samples):
        ray, keys = camera_wavefront(scene, camera, width, height, key, s)
        trace_keys = sampling.fold(keys, 4)
        for c in range(0, n_pix, PATH_CHUNK):
            with tracing.span("path.chunk"):
                sl = slice(c, min(c + PATH_CHUNK, n_pix))
                piece = Ray(ray.origin[sl], ray.dir[sl])
                if scene.media:
                    color, segs = trace_volumetric(scene, scene.tables, piece, trace_keys[sl],
                                                   media_max_depth, return_stats=True)
                else:
                    color, segs = trace_surface(scene, scene.tables, piece, trace_keys[sl],
                                                max_bounces, return_stats=True)
                total[sl] += color.to_array()
                segments += segs
    return _raster(total, width, height), int(segments)


def _photon_pass(scene, camera: Camera, width: int, height: int, pmap, key,
                 n_samples: int, gather_size: int, gather_size_volume: int,
                 occlusion_check: bool) -> np.ndarray:
    """Photon-map camera pass (photon.rs:950-985, `rpt_tpu/renderer.py:
    389-453`): one ``estimate_indirect`` per pixel sample, no camera
    recursion; its per-lane keys are fold 4 of the sample's. Returns the
    (H*W, 3) radiance sum in raster order, f64."""
    from .integrators.photon import estimate_indirect

    dev = scene.device
    n_pix = width * height
    total = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    for s in range(n_samples):
        with tracing.span("photon.sample"):
            ray, keys = camera_wavefront(scene, camera, width, height, key, s)
            ekeys = sampling.fold(keys, 4)
            for c in range(0, n_pix, PIXEL_CHUNK):
                with tracing.span("photon.estimate"):
                    sl = slice(c, min(c + PIXEL_CHUNK, n_pix))
                    color = estimate_indirect(scene, scene.tables, pmap,
                                              Ray(ray.origin[sl], ray.dir[sl]), ekeys[sl],
                                              gather_size, gather_size_volume, occlusion_check)
                    total[sl] += color.to_array()
    return _raster(total, width, height)


def _raster(total, width: int, height: int) -> np.ndarray:
    """The (H*W, 3) f32 sum of Morton-ordered lanes as a host f64 array in
    raster order."""
    with tracing.span("frontend.gather_out"):
        inv = torch.tensor(_pixel_grid(width, height)[3], device=total.device)
        return total[inv].cpu().numpy().astype(np.float64)
