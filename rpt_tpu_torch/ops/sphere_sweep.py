"""Beam-query x point-photon sphere sweep — port of the Pallas kernel
`rpt_tpu/ops/sphere_sweep.py::sphere_sweep` (K3).

For each camera ray, the sum over every photon sphere it pierces before
its surface hit of ``(3/pi)(1 - d^2/r^2)^2 / r^2 * exp(-ext*dd) *
phase_const * power``, times the medium colour. Spheres arrive as the
JAX package's field-major ``(FIELDS, P)`` table (`pack_spheres_transposed`),
P padded with zero-radius (inert) spheres.

`sphere_sweep` is the wrapper: for tensors on the CPU it runs
`sphere_sweep_plain`, a chunked dense sweep in torch ops; for CUDA tensors
it launches the hand-written kernel `csrc/sphere_sweep.cu` (K-sweep) or
raises. ``sphere_sweep.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from . import _build

SPHERE_CHUNK = 512
# transposed sphere table rows: px py pz radius dirx diry dirz powx powy powz
FIELDS = 10
THREADS = 256  # rays per block and spheres per shared-memory tile (sphere_sweep.cu)


def pack_spheres_transposed(pos, radius, direction, power) -> torch.Tensor:
    """(FIELDS, P) f32 sphere table on the inputs' device, P padded to a
    multiple of SPHERE_CHUNK with zero-radius (inert) spheres
    (`rpt_tpu/ops/sphere_sweep.py:135`). ``pos``/``direction``/``power``
    are (n, 3) tensors, ``radius`` (n,)."""
    n = radius.shape[0]
    p = max(SPHERE_CHUNK, -(-n // SPHERE_CHUNK) * SPHERE_CHUNK)
    out = torch.zeros((FIELDS, p), dtype=torch.float32, device=radius.device)
    out[0:3, :n] = pos.T
    out[3, :n] = radius
    out[4:7, :n] = direction.T
    out[7:10, :n] = power.T
    return out


def _check_args(ray_o, ray_d, hit_time, spheres_t, med_color):
    n = ray_o.shape[0]
    for name, t, shape in (("ray_o", ray_o, (n, 3)), ("ray_d", ray_d, (n, 3)),
                           ("hit_time", hit_time, (n,)), ("med_color", med_color, (3,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"sphere_sweep: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != ray_o.device:
            raise ValueError(f"sphere_sweep: {name} is on {t.device}, rays on {ray_o.device}")
    if spheres_t.dim() != 2 or spheres_t.shape[0] != FIELDS or spheres_t.dtype != torch.float32:
        raise ValueError(f"sphere_sweep: spheres_t must be float32 ({FIELDS}, P)")
    if spheres_t.device != ray_o.device:
        raise ValueError("sphere_sweep: spheres_t is not on the rays' device")


def sphere_sweep_plain(ray_o, ray_d, hit_time, spheres_t, ext: float, med_color,
                       n_spheres: int, phase_const: float) -> torch.Tensor:
    """Plain torch version: dense (rays, chunk) pair math, reduced per
    chunk by an FP32 matrix product (TF32 is off, `dtypes.py`)."""
    n = ray_o.shape[0]
    p = min(int(n_spheres), spheres_t.shape[1])
    scale = float(phase_const) * 3.0 / math.pi
    chunk = max(256, (1 << 26) // max(n, 1))
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
    dx, dy, dz = ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3]
    th = hit_time[:, None]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=ray_o.device)
    for s in range(0, p, chunk):
        sph = spheres_t[:, s : min(s + chunk, p)]
        ocx = sph[0][None, :] - ox
        ocy = sph[1][None, :] - oy
        ocz = sph[2][None, :] - oz
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        dd = ocx * dx + ocy * dy + ocz * dz
        dist2 = torch.clamp(oc2 - dd * dd, min=0.0)
        rad = sph[3][None, :]
        r2 = torch.clamp(rad * rad, min=1e-30)
        ok = (dd > 0.0) & (dist2 < r2) & (torch.sqrt(oc2) <= th) & (rad > 0.0)
        x = dist2 / r2
        k2 = (1.0 - x) * (1.0 - x)
        w = torch.where(ok, k2 / r2 * torch.exp(-ext * dd) * scale, 0.0)
        acc = acc + w @ sph[7:10].T
    return acc * med_color[None, :]


def sphere_sweep(ray_o, ray_d, hit_time, spheres_t, ext: float, med_color,
                 n_spheres: int, phase_const: float) -> torch.Tensor:
    """Accumulate the sphere-map volume estimate for every ray: (N, 3) f32.

    ``ray_o``/``ray_d``: (N, 3) f32; ``hit_time``: (N,) f32 (inf = miss);
    ``spheres_t``: (FIELDS, P) f32; ``ext``: the scalar extinction;
    ``med_color``: (3,) f32. CPU tensors take `sphere_sweep_plain`; CUDA
    tensors launch K-sweep."""
    _check_args(ray_o, ray_d, hit_time, spheres_t, med_color)
    if ray_o.device.type == "cpu":
        return sphere_sweep_plain(ray_o, ray_d, hit_time, spheres_t, ext, med_color,
                                  n_spheres, phase_const)
    if ray_o.device.type != "cuda":
        raise ValueError(f"sphere_sweep: unsupported device {ray_o.device}")
    n = ray_o.shape[0]
    p = spheres_t.shape[1]
    p_used = min(int(n_spheres), p)
    out = torch.zeros((n, 3), dtype=torch.float32, device=ray_o.device)
    if n == 0 or p_used == 0:
        return out
    ray_blocks = -(-n // THREADS)
    sms = torch.cuda.get_device_properties(ray_o.device).multi_processor_count
    tiles = -(-p_used // THREADS)
    # enough sphere splits to put ~4 blocks on every SM
    splits = max(1, min(tiles, -(-4 * sms // ray_blocks)))
    per_split = -(-tiles // splits) * THREADS
    splits = -(-p_used // per_split)
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    hit_time, spheres_t = hit_time.contiguous(), spheres_t.contiguous()
    med_color = med_color.contiguous()
    partial = torch.empty((splits, n, 3), dtype=torch.float32, device=ray_o.device)
    lib = _build.library().lib
    code = lib.rpt_sphere_sweep(
        ray_o.data_ptr(), ray_d.data_ptr(), hit_time.data_ptr(), n,
        spheres_t.data_ptr(), p, p_used, per_split, splits, float(ext),
        float(phase_const) * 3.0 / math.pi, med_color.data_ptr(), partial.data_ptr(),
        out.data_ptr(), _build.stream_of(ray_o),
    )
    sphere_sweep.launches += 1
    _build.check(code, "sphere_sweep")
    return out


sphere_sweep.launches = 0
