"""The photon map's estimates at the camera's hits (K-estimate).

The camera pass of a photon render estimates, for each lane, the light
the map holds around its hit (`rpt_tpu/integrators/photon.py`:
`surface_estimate`, the disk estimate on surfaces with its occlusion
recheck, photon.rs:327-375; `volume_estimate_point`, the point-query
estimate in a medium, photon.rs:384-437, whose surface term is the disk
estimate). Around two k-NN gathers and one any-hit query, both are elementwise
math over the lanes and their answers. The port's plain versions are
`surface_plain` and `point_plain` below, the chains of torch ops that
compute it: several hundred launches a wavefront on the card, each
gather's (n k, 12) rows and every lane's both estimates. The kernel is
`csrc/photon_estimate.cu`: a call of `surface` or `point` is three
launches (prep: the free flight and the gathers' queries; pairs: the
recheck rays; finish: the lane's own branch, its sums and its colour)
around the same gathers and recheck.

Both versions take the gather and the any-hit query as arguments (the
photon integrator's `knn_query`, read at each call where the benchmark
and the smoke run wrap it, and `intersect.occluded`), keep the spans of
the chain (``photon.gather_volume``, ``photon.gather``,
``photon.occlusion``), and take the same inputs. The integrator sends
CPU lanes to the plain versions and CUDA lanes to the kernel; the
wrappers serve CUDA tensors and, in a medium, a preset's
(`medium.MediumPreset`) only, and raise on anything else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, threefry
from .photon_shoot import _medium_constants
from .. import sampling, tracing
from ..dtypes import DTYPE
from ..materials import bsdf
from ..medium import SAMPLE_D_TAG
from ..ray import Ray
from ..vec import Vec3, where

FLIGHT_TAG = 0x7  # the free flight's fold of the lane's key (photon.rs:384-437)


# ---------------------------------------------------------------------------
# The plain versions: the chains of torch ops


def surface_plain(scene, tables, pmap, ray: Ray, hit, gather_size: int, occlusion_check: bool,
                  gather, occluded) -> Vec3:
    """Disk density estimate on surfaces (photon.rs:327-375), every
    (lane, photon) pair in one wavefront: the chain of torch ops."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    zero = Vec3.zeros(n, dev)
    if pmap.surface_grid.n == 0:
        return zero
    hitmask = hit.valid
    pos = where(hitmask, ray.at(hit.time), zero)
    wo = -ray.dir.normalize()
    mat = tables["materials"].lookup(hit.material)

    with tracing.span("photon.gather"):
        idx, d2, valid = gather(pmap.surface_grid, pos.to_array().contiguous(), gather_size)
    max_d2 = torch.where(valid, d2, 0.0).max(dim=1).values
    rows = pmap.surface[idx.reshape(-1)]  # (n*k, ROW), lane-major
    k = gather_size

    def rep(a):
        return a.expand(n).repeat_interleave(k)

    p_pos = Vec3(rows[:, 0], rows[:, 1], rows[:, 2])
    p_dir = Vec3(rows[:, 3], rows[:, 4], rows[:, 5])
    p_pow = Vec3(rows[:, 6], rows[:, 7], rows[:, 8])
    normal_f = hit.normal.map(rep)
    ok = valid.reshape(-1) & rep(hitmask)
    if occlusion_check:
        disp = pos.map(rep) - p_pos
        dist = disp.length()
        sray = Ray(p_pos, disp / torch.clamp(dist, min=1e-20))
        # dead lanes get limit -1: never occluded, never counted
        limit = torch.where(ok, dist * (1.0 - scene.shadow_eps), -1.0)
        with tracing.span("photon.occlusion"):
            ok = ok & ~occluded(scene, tables, sray, limit)
    f = bsdf(mat.repeat(k), normal_f, wo.map(rep), p_dir)
    contrib = f * p_pow * torch.clamp(p_dir.dot(normal_f), 0.0, 1.0)
    c = where(ok, contrib, Vec3.zeros(n * k, dev)).to_array().reshape(n, k, 3).sum(dim=1)
    color = mat.color_query() * mat.emittance_query() + Vec3(c[:, 0], c[:, 1], c[:, 2])
    inv = torch.where(max_d2 > 0.0, 1.0 / (math.pi * max_d2), 0.0)
    return where(hitmask, color * inv, zero)


def point_plain(scene, tables, pmap, medium, ray: Ray, hit, keys, gather_size: int,
                gather_size_volume: int, occlusion_check: bool, gather, occluded) -> Vec3:
    """Point-query volume estimate (photon.rs:384-437): a free-flight
    sample; where it ends before the hit, the density of the
    ``gather_size_volume`` nearest volume photons in their sphere; else
    the surface estimate, attenuated and divided by the chance of getting
    that far. The chain of torch ops; ``keys`` are the lanes' keys (a key
    tensor or a `sampling.KeyPath`)."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    zero = Vec3.zeros(n, dev)
    d, d_pdf, d_cdf = medium.sample_d(ray, sampling.key_path(keys).fold(FLIGHT_TAG))
    in_volume = ~hit.valid | (d < hit.time)

    collision = where(in_volume, ray.at(d), zero)
    wo = -ray.dir.normalize()
    med_color = medium.color(collision)
    ext = medium.extinction(collision)

    if pmap.volume_grid is not None and pmap.volume_grid.n > 0:
        kv = gather_size_volume
        with tracing.span("photon.gather_volume"):
            idx, d2, valid = gather(pmap.volume_grid, collision.to_array().contiguous(), kv)
        max_d2 = torch.where(valid, d2, 0.0).max(dim=1).values
        rows = pmap.volume[idx.reshape(-1)]  # (n*kv, ROW), lane-major

        def rep(a):
            return a.expand(n).repeat_interleave(kv)

        p_dir = Vec3(rows[:, 3], rows[:, 4], rows[:, 5])
        p_pow = Vec3(rows[:, 6], rows[:, 7], rows[:, 8])
        ph = medium.phase(wo.map(rep), p_dir)
        contrib = where(valid.reshape(-1), p_pow * med_color.map(rep) * ph,
                        Vec3.zeros(n * kv, dev))
        acc = contrib.to_array().reshape(n, kv, 3).sum(dim=1)
        denom = (4.0 / 3.0) * math.pi * torch.clamp(max_d2, min=1e-30) ** 1.5
        vol_color = Vec3(acc[:, 0], acc[:, 1], acc[:, 2]) / denom / ext
        vol_color = vol_color * (medium.transmittence(ray, d) / torch.clamp(d_pdf, min=1e-30))
        vol_color = where(max_d2 > 0.0, vol_color, zero)
    else:
        vol_color = zero

    surf = surface_plain(scene, tables, pmap, ray, hit, gather_size, occlusion_check, gather,
                         occluded)
    surf_att = surf * (medium.transmittence(ray, torch.where(hit.valid, hit.time, 0.0))
                       / torch.clamp(1.0 - d_cdf, min=1e-30))
    return where(in_volume, vol_color, where(hit.valid, surf_att, zero))


# ---------------------------------------------------------------------------
# The kernel


class _EstimateParams(ctypes.Structure):
    """`csrc/photon_estimate.cu` EstimateParams, passed by value to the
    kernels; the medium's fields are `_ShootParams`' (`_medium_constants`
    writes both)."""

    _P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
    _fields_ = [("lane", _P * 10), ("hit_material", _P), ("lane_stride", _L * 11), ("keys", _P),
                ("key_data", _P), ("mat_kind", _P), ("mat", _P * 5), ("mat_stride", _L * 6),
                ("v_rows", _P), ("s_rows", _P), ("v_idx", _P), ("v_d2", _P), ("s_idx", _P),
                ("s_d2", _P), ("occluded", _P), ("v_query", _P), ("s_query", _P),
                ("flight", _P), ("shadow", _P), ("out", _P), ("n", _I), ("k", _I), ("kv", _I),
                ("key_stride", _I), ("data_stride", _I), ("n_tags", _I),
                ("tags", ctypes.c_uint32 * threefry.MAX_TAGS), ("point", _I), ("volume", _I),
                ("surface", _I), ("recheck", _I), ("shadow_scale", _F), ("medium", _I),
                ("ext", _F), ("rr", _F), ("phase", _F), ("pdf", _F), ("color", _F * 3),
                ("color_below", _F * 3), ("split_y", _F), ("hg_invert", _I), ("hg_two_g", _F),
                ("hg_one_plus_g", _F), ("hg_one_minus_g2", _F), ("hg_one_plus_g2", _F),
                ("hg_inv_two_g", _F), ("hg_norm", _F)]


def _column(name: str, what: str, x, dtype, n: int, dev) -> torch.Tensor:
    """``x`` as a view of ``n`` lanes (a number or a 0-d tensor broadcast:
    stride 0), ``dtype`` on ``dev``."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or x.device != dev:
        raise ValueError(f"{name}: {what} must be a {dtype} tensor on {dev}, got "
                         f"{getattr(x, 'dtype', type(x).__name__)} on "
                         f"{getattr(x, 'device', None)}")
    if x.dim() == 1 and x.shape[0] == n:
        return x
    if x.dim() > 1 or (x.dim() == 1 and x.shape[0] != 1):
        raise ValueError(f"{name}: {what} must hold {n} lanes, got {tuple(x.shape)}")
    return x.reshape(-1).expand(n)


def _params(name: str, tables, ray: Ray, hit, n: int, dev) -> _EstimateParams:
    """The call's parameter block with its lanes and material table (views
    of the caller's tensors)."""
    p = _EstimateParams()
    comps = (ray.origin.x, ray.origin.y, ray.origin.z, ray.dir.x, ray.dir.y, ray.dir.z,
             hit.time, hit.normal.x, hit.normal.y, hit.normal.z)
    for c, x in enumerate(comps):
        x = _column(name, "the rays and hits", x, DTYPE, n, dev)
        p.lane[c], p.lane_stride[c] = x.data_ptr(), x.stride(0)
    material = _column(name, "the hit's material", hit.material, torch.int32, n, dev)
    p.hit_material, p.lane_stride[10] = material.data_ptr(), material.stride(0)
    mats = tables["materials"]
    cols = ((mats.kind, torch.int32), (mats.albedo.x, DTYPE), (mats.albedo.y, DTYPE),
            (mats.albedo.z, DTYPE), (mats.emittance, DTYPE), (mats.shininess, DTYPE))
    m = mats.kind.shape[0] if mats.kind.dim() == 1 else 0
    for c, (x, dtype) in enumerate(cols):
        if x.dtype != dtype or x.device != dev or x.shape != (m,) or m == 0:
            raise ValueError(f"{name}: the material table's columns must be (M,) with M > 0 on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if c:
            p.mat[c - 1] = x.data_ptr()
        p.mat_stride[c] = x.stride(0)
    p.mat_kind = mats.kind.data_ptr()
    p.n = n
    return p


def _flight_keys(p: _EstimateParams, keys, n: int):
    """The free flight's keys in ``p``: the lanes' key chain as
    `medium.sample_d` draws from it (`sampling.key_path(keys)` folded with
    `FLIGHT_TAG` and `SAMPLE_D_TAG`), flattened as K-rng's draw form takes
    it (`ops/threefry._prepare_draw`). Returns the flat call, whose
    tensors ``p`` points into: the caller keeps it until the launch."""
    path = sampling.key_path(keys).fold(FLIGHT_TAG).fold(SAMPLE_D_TAG)
    flat = threefry._prepare_draw(path.base, path.data, path.tags, (threefry.Draw(),), False)
    if flat.n not in (1, n):
        raise ValueError(f"point: {flat.n} keys for {n} lanes")
    if flat.keys.data_ptr() % 16:  # the kernel loads a key row as 16 bytes
        flat.keys = flat.keys.clone()
    p.keys, p.key_stride = flat.keys.data_ptr(), flat.key_stride
    if flat.data is not None:
        p.key_data, p.data_stride = flat.data.data_ptr(), flat.data_stride
    p.n_tags = len(flat.tags)
    p.tags[:len(flat.tags)] = flat.tags
    return flat


def _answers(idx: torch.Tensor, d2: torch.Tensor, n: int, k: int) -> tuple:
    """A gather's answers as the kernel reads them: (n, k) int64 and
    float32, contiguous."""
    if idx.dtype != torch.int64 or d2.dtype != DTYPE or idx.shape != (n, k) or \
            d2.shape != (n, k):
        raise ValueError(f"K-estimate: a gather must answer int64 and float32 ({n}, {k}), got "
                         f"{idx.dtype} {tuple(idx.shape)} and {d2.dtype} {tuple(d2.shape)}")
    return idx.contiguous(), d2.contiguous()


def _estimate(scene, tables, pmap, medium, ray: Ray, hit, keys, gather_size: int,
              gather_size_volume: int, occlusion_check: bool, gather, occluded) -> Vec3:
    """One K-estimate call: prep, the gathers, pairs and the recheck, then
    finish. ``medium`` None is the surface estimate, else the point
    query's."""
    name = "surface" if medium is None else "point"
    if medium is not None and medium.preset is None:
        raise ValueError("point: a medium of the caller's own callables has no preset for "
                         "K-estimate")
    n, dev = ray.origin.x.shape[0], ray.origin.x.device
    _build.on_card(name, ray.origin.x, n * max(gather_size, gather_size_volume))
    point, surface = medium is not None, pmap.surface_grid.n > 0
    volume = point and pmap.volume_grid is not None and pmap.volume_grid.n > 0
    if n == 0 or not (point or surface):
        return Vec3.zeros(n, dev)
    p = _params(name, tables, ray, hit, n, dev)
    p.k, p.kv, p.point, p.volume, p.surface = gather_size, gather_size_volume, point, volume, \
        surface
    f = dict(dtype=DTYPE, device=dev)
    out, s_query = torch.empty((3, n), **f), torch.empty((n, 3), **f)
    p.out, p.s_query = out.data_ptr(), s_query.data_ptr()
    if point:
        v_query, flight = torch.empty((n, 3), **f), torch.empty(n, **f)
        p.v_query, p.flight = v_query.data_ptr(), flight.data_ptr()
        flat = _flight_keys(p, keys, n)  # noqa: F841 (held until the launch)
        _medium_constants(p, medium)
    _build.launch("estimate_prep", "rpt_estimate_prep", out, ctypes.byref(p))

    if volume:
        with tracing.span("photon.gather_volume"):
            v_idx, v_d2, _ = gather(pmap.volume_grid, v_query, gather_size_volume)
        v_idx, v_d2 = _answers(v_idx, v_d2, n, gather_size_volume)
        v_rows = pmap.volume.contiguous()
        p.v_rows, p.v_idx, p.v_d2 = v_rows.data_ptr(), v_idx.data_ptr(), v_d2.data_ptr()
    if surface:
        with tracing.span("photon.gather"):
            s_idx, s_d2, _ = gather(pmap.surface_grid, s_query, gather_size)
        s_idx, s_d2 = _answers(s_idx, s_d2, n, gather_size)
        s_rows = pmap.surface.contiguous()
        p.s_rows, p.s_idx, p.s_d2 = s_rows.data_ptr(), s_idx.data_ptr(), s_d2.data_ptr()
        if occlusion_check:
            p.recheck, p.shadow_scale = 1, 1.0 - scene.shadow_eps
            shadow = torch.empty((7, n * gather_size), **f)
            p.shadow = shadow.data_ptr()
            _build.launch("estimate_pairs", "rpt_estimate_pairs", out, ctypes.byref(p))
            sray = Ray(Vec3(shadow[0], shadow[1], shadow[2]), Vec3(shadow[3], shadow[4], shadow[5]))
            with tracing.span("photon.occlusion"):
                occ = occluded(scene, tables, sray, shadow[6]).reshape(-1).contiguous()
            if occ.dtype != torch.bool or occ.shape[0] != n * gather_size:
                raise ValueError(f"K-estimate: the recheck must answer bool ({n * gather_size},), "
                                 f"got {occ.dtype} {tuple(occ.shape)}")
            p.occluded = occ.data_ptr()
    _build.launch("estimate_finish", "rpt_estimate_finish", out, ctypes.byref(p))
    return Vec3(out[0], out[1], out[2])


def surface(scene, tables, pmap, ray: Ray, hit, gather_size: int, occlusion_check: bool, gather,
            occluded) -> Vec3:
    """`surface_plain` for CUDA lanes: K-estimate's prep, the surface
    gather, its pairs and recheck, and finish (three launches around the
    gather and the recheck)."""
    return _estimate(scene, tables, pmap, None, ray, hit, None, gather_size, 0, occlusion_check,
                     gather, occluded)


def point(scene, tables, pmap, medium, ray: Ray, hit, keys, gather_size: int,
          gather_size_volume: int, occlusion_check: bool, gather, occluded) -> Vec3:
    """`point_plain` for CUDA lanes in a preset's medium: K-estimate's prep
    (the free flight), the volume and the surface gathers, the pairs and
    recheck, and finish, which evaluates only the branch each lane takes."""
    return _estimate(scene, tables, pmap, medium, ray, hit, keys, gather_size,
                     gather_size_volume, occlusion_check, gather, occluded)
