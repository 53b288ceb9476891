"""Photon mapping, point-photon x beam-query path — port of
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
* **Map building** (photon.rs:185-305): photon clouds are sorted into a
  uniform grid (`rpt_tpu_torch.accel.knn`); volume photons become spheres
  whose radius is the distance to their 10th nearest neighbour, itself
  included (photon.rs:216-226).
* **Estimates** (photon.rs:316-628): surface disk estimate with the
  per-photon occlusion recheck (:353-361), and the beam-query sphere
  estimate through the K-sweep kernel (`rpt_tpu_torch.ops.sphere_sweep`).

Reference quirks kept (PARITY.md "Deliberate deviations"): the emitted
term inside the surface estimate is divided by pi r^2 with the photon sum
(:344-369); deposits happen only on the RR-survive branch (:838-873);
volume photons deposit the PRE-attenuation power (:906-912); the cosine
term of a below-surface bounce is 1 (:846-850).

The photon-map (point query) and beam-beam kinds are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import torch

from .. import sampling
from ..accel.knn import PhotonGrid, build_grid, knn_query, knn_radius
from ..dtypes import DTYPE, INF
from ..intersect import closest_hit, occluded
from ..lights import sample_shape
from ..materials import bsdf, sample_f
from ..ops.sphere_sweep import (
    SphereTable, build_sphere_table, pack_spheres_transposed, sphere_sweep,
)
from ..ray import Ray
from ..vec import Vec3, where

POINT_BEAM = "point_beam"

PHOTON_ROW = 12  # [pos(3), dir(3), power(3), start(3)]
RADIUS_K = 10  # photon sphere radius: distance to the 10th NN (photon.rs:216-226)


def _require_point_beam(kind: str):
    if kind != POINT_BEAM:
        raise NotImplementedError(
            f"photon kind {kind!r} is not ported yet; the port runs {POINT_BEAM!r}")


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


def _shoot_launch(scene, tables, light_index: int, power_scalar: float, max_depth: int,
                  n: int, key):
    """One chunk of ``n`` photons: returns (surface rows, volume rows,
    dropped count) (`rpt_tpu/integrators/photon.py:137-294`)."""
    dev = scene.device
    lstat = scene.lights[light_index]
    medium = scene.media[0] if scene.media else None
    s_cap = 4 * n
    v_cap = 10 * n if medium is not None else 16
    materials = tables["materials"]

    keys = sampling.keys_for(key, n)
    pos, nrm, _ = sample_shape(lstat, tables["lights"][light_index], Vec3.zeros(n, dev),
                               sampling.fold(keys, 1))
    r1, r2 = sampling.uniform2(sampling.fold(keys, 2))
    direction, _ = sampling.uniform_hemisphere(r1, r2, nrm)
    # power = watts/count * material.color() (photon.rs:763, NOT scaled by
    # emittance)
    power = Vec3.of(*lstat.color, device=dev).broadcast_to((n,)) * power_scalar
    ray = Ray(pos, direction)

    s_out, v_out = [], []
    for b in range(max_depth):
        if ray.origin.x.shape[0] == 0:
            break
        nw = ray.origin.x.shape[0]
        zero = Vec3.zeros(nw, dev)
        kb = sampling.fold(keys, b)
        wo = -ray.dir.normalize()
        hit = closest_hit(scene, tables, ray)

        # ---- volume interaction (photon.rs:877-915) -------------------
        if medium is not None:
            d, _, _ = medium.sample_d(ray, sampling.fold(kb, 1))
            vol_event = d < torch.where(hit.valid, hit.time, INF)
            collision = where(vol_event, ray.at(d), zero)
            med_color = medium.color(collision)
            rr_prob = medium.scattering(collision) / medium.extinction(collision)
            u_v = sampling.uniform(sampling.fold(kb, 2))
            wi_v, ph_p = medium.sample_ph(wo, sampling.fold(kb, 3))
            ph = medium.phase(wo, wi_v)
            vol_continue = vol_event & (u_v < rr_prob)
            vol_power_next = power * med_color * (rr_prob * ph / torch.clamp(ph_p, min=1e-20))
        else:
            vol_event = torch.zeros(nw, dtype=torch.bool, device=dev)
            collision = zero
            wi_v = wo
            vol_continue = vol_event
            vol_power_next = power
        surf_event = hit.valid & ~vol_event

        # ---- surface interaction (photon.rs:813-874) ------------------
        mat = materials.lookup(hit.material)
        spos = where(surf_event, ray.at(hit.time), zero)
        p_d = 0.7  # hardcoded diffuse RR (photon.rs:821-833)
        u_s = sampling.uniform(sampling.fold(kb, 4))
        wi_s, pdf_s, valid_s = sample_f(mat, hit.normal, wo, sampling.fold(kb, 5))
        f = bsdf(mat, hit.normal, wo, wi_s)
        cos_raw = wi_s.dot(hit.normal)
        cosine_term = torch.where(cos_raw > 0.0, cos_raw, 1.0)  # photon.rs:846-850
        surf_continue = surf_event & (u_s < p_d) & valid_s
        surf_power_next = power * f * (cosine_term / (torch.clamp(pdf_s, min=1e-20) * p_d))
        # deposit only on the survive branch, never on mirrors (:838-873)
        surf_deposit = surf_continue & ~mat.is_mirror()

        # ---- deposits: [pos, wo, PRE-attenuation power, beam start] ----
        dpos = where(vol_event, collision, spos)
        rows = torch.stack(
            [dpos.x, dpos.y, dpos.z, wo.x, wo.y, wo.z,
             power.x.expand(nw), power.y.expand(nw), power.z.expand(nw),
             ray.origin.x.expand(nw), ray.origin.y.expand(nw), ray.origin.z.expand(nw)],
            dim=1,
        )
        s_out.append(rows[surf_deposit])
        v_out.append(rows[vol_event])

        # ---- next level: survivors compacted in lane order -------------
        cont = vol_continue | surf_continue
        new_power = where(vol_event, vol_power_next, surf_power_next)
        new_ray = Ray(dpos, where(vol_event, wi_v, wi_s))
        sel = torch.nonzero(cont).squeeze(1)
        ray = Ray(new_ray.origin[sel], new_ray.dir[sel])
        power = new_power.broadcast_to((nw,))[sel]
        keys = keys[sel]

    s_rows, v_rows = torch.cat(s_out), torch.cat(v_out)
    dropped = max(0, s_rows.shape[0] - s_cap) + max(0, v_rows.shape[0] - v_cap)
    return s_rows[:s_cap], v_rows[:v_cap], dropped


# ---------------------------------------------------------------------------
# Pass 2: map building


@dataclass
class PhotonMapData:
    """Point-beam photon map: the surface cloud in grid order (``surface``
    rows indexed by the k-NN's ``idx``) and the photon spheres as K-sweep's
    table (`ops.sphere_sweep.build_sphere_table`, built once per map)."""

    kind: str
    surface_grid: PhotonGrid
    surface: torch.Tensor  # (S, PHOTON_ROW), grid order
    spheres: SphereTable


def build_photon_map(scene, tables, surface_rows, volume_rows, kind: str,
                     gather_size: int) -> PhotonMapData:
    """`rpt_tpu/integrators/photon.py:369-421` for the point-beam kind."""
    _require_point_beam(kind)
    s_grid = build_grid(surface_rows[:, 0:3].contiguous())
    surface = surface_rows[s_grid.order]

    v_grid = build_grid(volume_rows[:, 0:3].contiguous())
    v = volume_rows[v_grid.order]
    nv = v.shape[0]
    radius = _knn_radius_device(v_grid, RADIUS_K)
    if nv:
        print("Finished calculating Photon radiuses "
              f"{(float(radius.mean()), float(radius.max()), float(radius.min()))}")
    spheres = build_sphere_table(
        pack_spheres_transposed(v[:, 0:3], radius, v[:, 3:6], v[:, 6:9]), nv)
    return PhotonMapData(kind, s_grid, surface, spheres)


def _knn_radius_device(grid: PhotonGrid, k: int) -> torch.Tensor:
    """Per photon (grid order), the distance to its k-th nearest neighbour,
    itself included (`rpt_tpu/integrators/photon.py:459`)."""
    return torch.sqrt(knn_radius(grid, k))


# ---------------------------------------------------------------------------
# Pass 3: camera estimates


def surface_estimate(scene, tables, pmap: PhotonMapData, ray: Ray, hit, gather_size: int,
                     occlusion_check: bool = True) -> Vec3:
    """Disk density estimate on surfaces (photon.rs:327-375), every
    (lane, photon) pair in one wavefront."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    zero = Vec3.zeros(n, dev)
    if pmap.surface_grid.n == 0:
        return zero
    hitmask = hit.valid
    pos = where(hitmask, ray.at(hit.time), zero)
    wo = -ray.dir.normalize()
    mat = tables["materials"].lookup(hit.material)

    idx, d2, valid = knn_query(pmap.surface_grid, pos.to_array().contiguous(), gather_size)
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
        ok = ok & ~occluded(scene, tables, sray, limit)
    f = bsdf(mat.repeat(k), normal_f, wo.map(rep), p_dir)
    contrib = f * p_pow * torch.clamp(p_dir.dot(normal_f), 0.0, 1.0)
    c = where(ok, contrib, Vec3.zeros(n * k, dev)).to_array().reshape(n, k, 3).sum(dim=1)
    color = mat.color_query() * mat.emittance_query() + Vec3(c[:, 0], c[:, 1], c[:, 2])
    inv = torch.where(max_d2 > 0.0, 1.0 / (math.pi * max_d2), 0.0)
    return where(hitmask, color * inv, zero)


def volume_estimate_spheres(pmap: PhotonMapData, medium, ray: Ray, hit) -> Vec3:
    """Beam-query x point-photon estimate (photon.rs:439-501): every photon
    sphere the ray pierces before its hit, through K-sweep. Needs a
    constant-phase medium (both ported presets are)."""
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    if pmap.spheres.n_spheres == 0:
        return Vec3.zeros(n, dev)
    if medium.phase_const is None:
        raise NotImplementedError("the sphere sweep needs a constant-phase medium")
    med_color = medium.color(Vec3.zeros(n, dev))
    ext = float(medium.extinction(Vec3.zeros((), dev)))
    hit_time = torch.where(hit.valid, hit.time, INF)
    out = sphere_sweep(
        ray.origin.to_array().contiguous(), ray.dir.to_array().contiguous(), hit_time,
        pmap.spheres, ext, torch.ones(3, dtype=DTYPE, device=dev),
        n_spheres=pmap.spheres.n_spheres, phase_const=float(medium.phase_const),
    )
    return Vec3(out[:, 0], out[:, 1], out[:, 2]) * med_color


def estimate_indirect(scene, tables, pmap: PhotonMapData, ray: Ray, gather_size: int,
                      occlusion_check: bool = True) -> Vec3:
    """Dispatch on (hit?, medium?) — photon.rs:600-627, point-beam kind."""
    medium = scene.media[0] if scene.media else None
    hit = closest_hit(scene, tables, ray)
    surf = surface_estimate(scene, tables, pmap, ray, hit, gather_size, occlusion_check)
    if medium is None:
        return where(hit.valid, surf, scene.env_color(tables, ray.dir))
    _require_point_beam(pmap.kind)
    vol = volume_estimate_spheres(pmap, medium, ray, hit)
    t_surf = medium.transmittence(ray, torch.where(hit.valid, hit.time, 0.0))
    return vol + where(hit.valid, surf * t_surf, Vec3.zeros(hit.time.shape[0], hit.time.device))
