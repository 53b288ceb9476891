"""Photon mapping, all three kinds (photon map with point queries,
point-photon x beam-query, beam x beam) — port of
`rpt_tpu/integrators/photon.py` (`rpt/src/photon.rs`).

* **Shooting** (photon.rs:655-946): photons leave the FIRST object light
  (the reference's FIXME at :725-727) with uniform-hemisphere emission and
  bounce with the reference's hardcoded diffuse RR p_d = 0.7 (:821-833)
  on surfaces and sigma_s/sigma_t RR in media. The per-ray recursion is a
  loop over bounce levels; after each level the surviving lanes are
  compacted in order, so deposits land in the JAX package's order
  (lane order within a level, levels in sequence). Deposits beyond the
  capacities (4 per photon on surfaces, 10 in media) are dropped and
  counted.
* **Map building** (photon.rs:185-305): the surface cloud is sorted into
  a grid (`rpt_tpu_torch.accel.knn`). By kind, the volume photons are
  sorted into a second grid (photon map); become spheres whose radius is
  the distance to their 10th nearest neighbour, itself included
  (point-beam, photon.rs:216-226); or are thinned to 0.1% on the host,
  in shoot order, and become beams of radius 3 from the photon's start to
  its deposit, with 1000x the power (beam-beam, photon.rs:773-793).
* **Estimates** (photon.rs:316-628): surface disk estimate with the
  per-photon occlusion recheck (:353-361); the point-query sphere density
  at a sampled collision (:384-437, K-knn over the volume grid), both
  computed around their gathers by K-estimate on the card
  (`rpt_tpu_torch.ops.photon_estimate`) and by its chain of torch ops on
  the CPU; the
  beam-query sphere estimate (:439-501) through the K-sweep kernel
  (`rpt_tpu_torch.ops.sphere_sweep`) for constant-phase media and through
  a chunked pair sweep in torch ops for the others, as the JAX package
  dispatches it; and the beam x beam estimate (:503-593), (lane, beam)
  pair math in chunks of beams.

Reference quirks kept (PARITY.md "Deliberate deviations"): the emitted
term inside the surface estimate is divided by pi r^2 with the photon sum
(:344-369); deposits happen only on the RR-survive branch (:838-873);
volume photons deposit the PRE-attenuation power (:906-912); the cosine
term of a below-surface bounce is 1 (:846-850); the beam x beam estimate
accepts only intersections in front of the ray origin (``t > 0``).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import sampling, tracing
from ..accel.knn import PhotonGrid, build_grid, knn_query, knn_radius
from ..dtypes import DTYPE, INF
from ..intersect import closest_hit, occluded
from ..lights import sample_shape
from ..ops import photon_estimate, photon_shoot
from ..ops.sphere_sweep import (
    SphereTable, build_sphere_table, pack_spheres_transposed, sphere_sweep,
    sphere_sweep_phase,
)
from ..ray import Ray
from ..vec import Vec3, where

PHOTON_MAP = "photon_map"
POINT_BEAM = "point_beam"
BEAM_BEAM = "beam_beam"

PHOTON_ROW = 12  # [pos(3), dir(3), power(3), start(3)]
RADIUS_K = 10  # photon sphere radius: distance to the 10th NN (photon.rs:216-226)
BEAM_THIN = 0.001  # photon.rs:780: beam maps keep 0.1% of the volume photons
BEAM_RADIUS = 3.0  # fixed beam radius (photon.rs:277)
BEAM_PAIRS = 1 << 24  # (lane, beam) pairs per chunk of the beam estimate


def _find_object_light(scene):
    """First Light::Object (photon.rs:725-798; panics if none)."""
    for i, light in enumerate(scene.lights):
        if light.kind == "object":
            return i, light
    raise RuntimeError("Only found non-object lights while photon mapping")


# ---------------------------------------------------------------------------
# Pass 1: shooting


@dataclass
class PhotonList:
    """Deposited photons: ``surface`` (S, PHOTON_ROW) and ``volume``
    (V, PHOTON_ROW) float32 rows on the scene's device, and the number of
    deposits dropped at the capacities."""

    surface: torch.Tensor
    volume: torch.Tensor
    dropped: int


def shoot_photons_device(scene, tables, key, photon_count: int, watts: float,
                         max_depth: int = 48, chunk: int = 1 << 19) -> PhotonList:
    """Shoot ``photon_count`` photons in equal chunks (`rpt_tpu/integrators/
    photon.py:68`): chunk ``ci`` draws its keys from ``fold_in(key,
    ci * n_eq)``; when the count does not divide evenly, ``nchunks * n_eq
    >= photon_count`` photons are emitted and per-photon power is scaled
    by that true emission count."""
    li, _ = _find_object_light(scene)
    nchunks = max(1, -(-photon_count // chunk))
    n_eq = -(-photon_count // nchunks)
    power_scalar = watts / (nchunks * n_eq)
    surface, volume = [], []
    dropped = 0
    for ci in range(nchunks):
        s_rows, v_rows, d = _shoot_launch(
            scene, tables, li, power_scalar, max_depth, n_eq,
            sampling.fold_in(key, ci * n_eq),
        )
        surface.append(s_rows)
        volume.append(v_rows)
        dropped += d
    if dropped:
        print(f"rpt_tpu_torch: photon deposit capacity dropped {dropped} photons",
              file=sys.stderr)
    return PhotonList(torch.cat(surface), torch.cat(volume), dropped)


def _emit(scene, tables, light_index: int, power_scalar: float, n: int, key):
    """A chunk's ``n`` photons leaving the light: their rays, powers and
    keys (a `sampling.KeyPath` of ``keys_for(key, n)``) at level 0."""
    dev = scene.device
    lstat = scene.lights[light_index]
    keys = sampling.key_path(sampling.keys_for(key, n))
    pos, nrm, _ = sample_shape(lstat, tables["lights"][light_index], Vec3.zeros(n, dev),
                               sampling.fold(keys, 1))
    r1, r2 = sampling.uniform2(sampling.fold(keys, 2))
    direction, _ = sampling.uniform_hemisphere(r1, r2, nrm)
    # power = watts/count * material.color() (photon.rs:763, NOT scaled by
    # emittance)
    power = Vec3.of(*lstat.color, device=dev).broadcast_to((n,)) * power_scalar
    return Ray(pos, direction), power, keys


def _shoot_launch(scene, tables, light_index: int, power_scalar: float, max_depth: int,
                  n: int, key):
    """One chunk of ``n`` photons: returns (surface rows, volume rows,
    dropped count) (`rpt_tpu/integrators/photon.py:137-294`). A level is
    `closest_hit`, then its interaction: K-shoot (`ops/photon_shoot.py`)
    on the card, which refuses a medium of the caller's own callables, and
    the chain of torch ops, `shoot_level_plain`, on the CPU."""
    dev = scene.device
    medium = scene.media[0] if scene.media else None
    s_cap = 4 * n
    v_cap = 10 * n if medium is not None else 16
    materials = tables["materials"]
    ray, power, keys = _emit(scene, tables, light_index, power_scalar, n, key)

    if dev.type == "cuda":
        chunk = photon_shoot.ShootChunk(ray, power, keys.base, materials, medium, max_depth,
                                        s_cap, v_cap)
        for b in range(max_depth):
            if chunk.lanes == 0:
                break
            with tracing.span("photon.shoot_level", chunk.lanes):
                photon_shoot.shoot_level(chunk, closest_hit(scene, tables, chunk.ray()), b)
        return chunk.rows()

    s_out, v_out = [], []
    for b in range(max_depth):
        nw = ray.origin.x.shape[0]
        if nw == 0:
            break
        with tracing.span("photon.shoot_level", nw):
            hit = closest_hit(scene, tables, ray)
            s_rows, v_rows, ray, power, keys = photon_shoot.shoot_level_plain(
                ray, power, keys, hit, b, medium, materials)
        s_out.append(s_rows)
        v_out.append(v_rows)

    s_rows, v_rows = torch.cat(s_out), torch.cat(v_out)
    dropped = max(0, s_rows.shape[0] - s_cap) + max(0, v_rows.shape[0] - v_cap)
    return s_rows[:s_cap], v_rows[:v_cap], dropped


# ---------------------------------------------------------------------------
# Pass 2: map building


@dataclass
class BeamTable:
    """The photon beams of the beam-beam kind, (B, 3) and (B,) f32 tensors:
    a beam runs ``length`` along the unit ``dir`` from ``start``."""

    start: torch.Tensor
    dir: torch.Tensor
    length: torch.Tensor
    radius: torch.Tensor
    power: torch.Tensor

    @property
    def n_beams(self) -> int:
        return int(self.length.shape[0])


@dataclass
class PhotonMapData:
    """A photon map: the surface cloud in grid order (``surface`` rows
    indexed by the k-NN's ``idx``) and, by ``kind``, the volume cloud in
    its own grid (photon map), the photon spheres as K-sweep's table
    (point-beam; `ops.sphere_sweep.build_sphere_table`, built once per
    map), or the beams (beam-beam)."""

    kind: str
    surface_grid: PhotonGrid
    surface: torch.Tensor  # (S, PHOTON_ROW), grid order
    volume_grid: PhotonGrid | None = None
    volume: torch.Tensor | None = None  # (V, PHOTON_ROW), grid order
    spheres: SphereTable | None = None
    beams: BeamTable | None = None


def beam_keep_mask(rng: np.random.Generator, n_volume: int) -> np.ndarray:
    """The volume photons (shoot order) that become beams: a draw per row
    from the host generator, as `rpt_tpu/integrators/photon.py:427`, so
    both packages keep the same rows of the same shoot."""
    return rng.random(n_volume) < BEAM_THIN


def build_photon_map(scene, tables, surface_rows, volume_rows, kind: str, gather_size: int,
                     gather_size_volume: int, rng: np.random.Generator) -> PhotonMapData:
    """`rpt_tpu/integrators/photon.py:369`. ``rng`` is the host generator
    that thins the beam-beam kind's volume photons; the gather sizes are
    part of the JAX package's signature and size nothing here (the grid
    does not depend on k)."""
    if kind not in (PHOTON_MAP, POINT_BEAM, BEAM_BEAM):
        raise ValueError(f"unknown photon map kind {kind!r}")
    s_grid = build_grid(surface_rows[:, 0:3].contiguous())
    data = PhotonMapData(kind, s_grid, surface_rows[s_grid.order])

    if kind == PHOTON_MAP:
        data.volume_grid = build_grid(volume_rows[:, 0:3].contiguous())
        data.volume = volume_rows[data.volume_grid.order]
    elif kind == POINT_BEAM:
        v_grid = build_grid(volume_rows[:, 0:3].contiguous())
        v = volume_rows[v_grid.order]
        nv = v.shape[0]
        with tracing.span("photon.knn_radius"):
            radius = _knn_radius_device(v_grid, RADIUS_K)
        if nv:
            print("Finished calculating Photon radiuses "
                  f"{(float(radius.mean()), float(radius.max()), float(radius.min()))}")
        with tracing.span("photon.sphere_table"):
            data.spheres = build_sphere_table(
                pack_spheres_transposed(v[:, 0:3], radius, v[:, 3:6], v[:, 6:9]), nv)
    else:
        # thinned in shoot order, before any sort (photon.rs:773-793)
        keep = torch.from_numpy(beam_keep_mask(rng, volume_rows.shape[0]))
        b = volume_rows[keep.to(volume_rows.device)]
        start, end = b[:, 9:12], b[:, 0:3]
        seg = end - start
        length = torch.linalg.vector_norm(seg, dim=1)
        nb = b.shape[0]
        data.beams = BeamTable(
            start=start.contiguous(),
            dir=seg / torch.clamp(length, min=1e-12)[:, None],
            length=length,
            radius=torch.full((nb,), BEAM_RADIUS, dtype=DTYPE, device=b.device),
            power=b[:, 6:9] / BEAM_THIN,
        )
        r = BEAM_RADIUS if nb else 0.0
        print(f"Finished calculating photon beam radiuses {(r, r, r)}")
    return data


def _knn_radius_device(grid: PhotonGrid, k: int) -> torch.Tensor:
    """Per photon (grid order), the distance to its k-th nearest neighbour,
    itself included (`rpt_tpu/integrators/photon.py:459`)."""
    return torch.sqrt(knn_radius(grid, k))


# ---------------------------------------------------------------------------
# Pass 3: camera estimates


def surface_estimate(scene, tables, pmap: PhotonMapData, ray: Ray, hit, gather_size: int,
                     occlusion_check: bool = True) -> Vec3:
    """Disk density estimate on surfaces (photon.rs:327-375), every
    (lane, photon) pair in one wavefront: K-estimate on the card, the chain
    of torch ops on the CPU (`ops/photon_estimate.py`), each around this
    module's `knn_query` and `occluded`."""
    estimate = (photon_estimate.surface if ray.origin.x.device.type == "cuda"
                else photon_estimate.surface_plain)
    return estimate(scene, tables, pmap, ray, hit, gather_size, occlusion_check, knn_query,
                    occluded)


def volume_estimate_point(scene, tables, pmap: PhotonMapData, medium, ray: Ray, hit, keys,
                          gather_size: int, gather_size_volume: int,
                          occlusion_check: bool = True) -> Vec3:
    """Point-query volume estimate (photon.rs:384-437): a free-flight
    sample; where it ends before the hit, the density of the
    ``gather_size_volume`` nearest volume photons in their sphere; else
    the surface estimate, attenuated and divided by the chance of getting
    that far. K-estimate on the card (a preset's medium; bare callables
    are refused), the chain of torch ops on the CPU
    (`ops/photon_estimate.py`), each around this module's `knn_query` and
    `occluded`."""
    estimate = (photon_estimate.point if ray.origin.x.device.type == "cuda"
                else photon_estimate.point_plain)
    return estimate(scene, tables, pmap, medium, ray, hit, keys, gather_size, gather_size_volume,
                    occlusion_check, knn_query, occluded)


def _k2(x):
    """Silverman-like blur kernel k2 (photon.rs:466-469)."""
    t = 1.0 - x
    return (3.0 / math.pi) * t * t


def volume_estimate_spheres(pmap: PhotonMapData, medium, ray: Ray, hit) -> Vec3:
    """Beam-query x point-photon estimate (photon.rs:439-501): every photon
    sphere the ray pierces before its hit. A constant-phase medium goes
    through K-sweep; one whose phase depends on the directions takes the
    chunked pair sweep in torch ops with ``phase(-photon_dir, -ray_dir)``
    per pair, on any device (the JAX package's dispatch,
    `rpt_tpu/integrators/photon.py:650-718`)."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    if pmap.spheres.n_spheres == 0:
        return Vec3.zeros(n, dev)
    med_color = medium.color(Vec3.zeros(n, dev))
    ext = float(medium.extinction(Vec3.zeros((), dev)))
    hit_time = torch.where(hit.valid, hit.time, INF)
    ray_o, ray_d = ray.origin.to_array().contiguous(), ray.dir.to_array().contiguous()
    one = torch.ones(3, dtype=DTYPE, device=dev)

    def phase(photon_dir, ray_dir):
        return medium.phase(-Vec3(*photon_dir), -Vec3(*ray_dir))

    with tracing.span("photon.sweep"):
        if medium.phase_const is None:
            out = sphere_sweep_phase(ray_o, ray_d, hit_time, pmap.spheres.spheres_t, ext, one,
                                     pmap.spheres.n_spheres, phase)
        else:
            out = sphere_sweep(ray_o, ray_d, hit_time, pmap.spheres, ext, one,
                               n_spheres=pmap.spheres.n_spheres,
                               phase_const=float(medium.phase_const))
    return Vec3(out[:, 0], out[:, 1], out[:, 2]) * med_color


def volume_estimate_beams(pmap: PhotonMapData, medium, ray: Ray, hit) -> Vec3:
    """Beam x beam estimate, eq. 38 of Jarosz et al. (photon.rs:503-593):
    the (lane, beam) pair math of `rpt_tpu/integrators/photon.py:739-779`
    over all lanes and a chunk of beams at a time, summed over the beams.
    A ray parallel to a beam normalises a zero cross product to NaN: pairs
    are masked before the sum. ``t > 0`` is the JAX package's deliberate
    deviation (PARITY.md)."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    beams = pmap.beams
    if beams.n_beams == 0:
        return Vec3.zeros(n, dev)
    med_color = medium.color(Vec3.zeros(n, dev))
    ext = medium.extinction(Vec3.zeros(n, dev))[:, None]
    hit_time = torch.where(hit.valid, hit.time, INF)[:, None]
    lanes = Ray(ray.origin.map(lambda c: c[:, None]), ray.dir.map(lambda c: c[:, None]))

    acc = torch.zeros((n, 3), dtype=DTYPE, device=dev)
    chunk = max(64, BEAM_PAIRS // max(n, 1))
    for s in range(0, beams.n_beams, chunk):
        e = min(s + chunk, beams.n_beams)
        bstart = Vec3(*(beams.start[None, s:e, i] for i in range(3)))
        bdir = Vec3(*(beams.dir[None, s:e, i] for i in range(3)))
        blen = beams.length[None, s:e]
        brad = torch.clamp(beams.radius[None, s:e], min=1e-20)

        l = bstart - lanes.origin
        u = l.cross(bdir).normalize()
        nn = bdir.cross(u).normalize()
        t = nn.dot(l) / nn.dot(lanes.dir)
        qc = lanes.at(t)
        ok = (t < hit_time) & (t > 0.0)

        cosb = lanes.dir.dot(bdir)
        inv_sin = 1.0 / torch.sqrt(torch.clamp(1.0 - cosb * cosb, min=1e-12))
        beam_t = bdir.dot(qc - bstart)
        ok = ok & (beam_t >= 0.0) & (beam_t <= blen)
        dist = (qc - (bstart + bdir * beam_t)).length()
        ok = ok & (dist < beams.radius[None, s:e])

        ph = medium.phase(-bdir.broadcast_to(t.shape), -lanes.dir.broadcast_to(t.shape))
        w = (ext * ph * inv_sin * torch.exp(-ext * t) * torch.exp(-ext * beam_t)
             * _k2(dist / brad) / (2.0 * brad))
        acc = acc + torch.where(ok, w, 0.0) @ beams.power[s:e]
    return Vec3(acc[:, 0], acc[:, 1], acc[:, 2]) * med_color


def estimate_indirect(scene, tables, pmap: PhotonMapData, ray: Ray, keys, gather_size: int,
                      gather_size_volume: int, occlusion_check: bool = True) -> Vec3:
    """Dispatch on (hit?, medium?, map kind) — photon.rs:600-627. ``keys``
    are the per-lane estimate keys; only the photon-map kind draws from
    them (its free-flight sample)."""
    medium = scene.media[0] if scene.media else None
    hit = closest_hit(scene, tables, ray)
    if medium is None:
        surf = surface_estimate(scene, tables, pmap, ray, hit, gather_size, occlusion_check)
        return where(hit.valid, surf, scene.env_color(tables, ray.dir))
    if pmap.kind == PHOTON_MAP:
        # the surface term is handled inside (photon.rs:610-613); a full miss
        # still evaluates the volume estimate (photon.rs:603)
        return volume_estimate_point(scene, tables, pmap, medium, ray, hit, keys, gather_size,
                                     gather_size_volume, occlusion_check)
    if pmap.kind == POINT_BEAM:
        vol = volume_estimate_spheres(pmap, medium, ray, hit)
    else:
        vol = volume_estimate_beams(pmap, medium, ray, hit)
    surf = surface_estimate(scene, tables, pmap, ray, hit, gather_size, occlusion_check)
    t_surf = medium.transmittence(ray, torch.where(hit.valid, hit.time, 0.0))
    return vol + where(hit.valid, surf * t_surf, Vec3.zeros(hit.time.shape[0], hit.time.device))
