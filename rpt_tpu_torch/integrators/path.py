"""Wavefront path tracing — port of `rpt_tpu/integrators/path.py`
(`rpt/src/renderer.rs:188-321`).

``trace_surface`` runs the per-ray recursion of ``Renderer::trace_ray`` as
a loop over bounce levels, each over the whole wavefront: emission at
bounce 0, next-event estimation at every hit, and the per-level firefly
clamp of 100 on the *sub-path* result (renderer.rs:311-313). Because the
clamp wraps the recursive return value, the forward loop collects per-level
(contribution, factor) pairs and folds them backwards:
``L_b = contrib_b + min(factor_b * L_{b+1}, 100)``.

Each level runs one closest-hit query and one occlusion query for all
lights' shadow rays together (one concatenated wavefront). Shadow
semantics are the JAX package's: no occluder strictly closer than the
light (`rpt_tpu/integrators/path.py:23-29`), or with ``nee_mode ==
"exact"`` the reference's closest-hit-at-the-light test.

``trace_volumetric`` is the media branch (renderer.rs:188-285): per level
a free-flight distance against the closest hit decides between a medium
event, a surface event and an escape; both kinds of event run next-event
estimation from one shared point, radiance accumulates forwards as
``L += throughput * contrib`` with no firefly clamp, and Russian roulette
(p = 0.8) ends paths. The JAX scan runs every level over the whole
wavefront; here the surviving lanes are compacted between levels. Keys are
per lane, so a lane's radiance does not depend on the compaction.

Not ported: the JAX package's pooled schedule (``POOLED_SCHEDULE``,
``mixed_closest_occluded``), which is TPU scheduling.
"""

from __future__ import annotations

import torch

from .. import sampling
from ..dtypes import DTYPE
from ..intersect import closest_hit, occluded
from ..lights import illuminate
from ..materials import bsdf, sample_f
from ..ray import Ray
from ..vec import Vec3, where

FIREFLY_CLAMP = 100.0  # renderer.rs:18
BACKGROUND_DIST = 400.0  # renderer.rs:199
RR_P = 0.8  # renderer.rs:193

# Dead lanes trace this ray instead of one from a sanitized origin: far
# outside every scene, pointing away, so every traversal rejects it at the
# root (`rpt_tpu/integrators/path.py:72-84`).
_DEAD_POS = 1e7


def _sanitize(pos: Vec3, mask) -> Vec3:
    return where(mask, pos, Vec3.zeros(mask.shape, mask.device))


def _dead_ray_fields(n: int, device):
    far = torch.full((n,), _DEAD_POS, dtype=DTYPE, device=device)
    zero = torch.zeros(n, dtype=DTYPE, device=device)
    return Vec3(far, far, far), Vec3(zero, torch.ones(n, dtype=DTYPE, device=device), zero)


def _nonzero_contrib(contrib: Vec3):
    """Shadow lanes whose NEE contribution is already zero need no
    occlusion traversal: their visibility is multiplied by zero."""
    return (contrib.x != 0.0) | (contrib.y != 0.0) | (contrib.z != 0.0)


def sample_lights(scene, tables, mat, pos: Vec3, n: Vec3, wo: Vec3, keys, mask=None) -> Vec3:
    """renderer.rs:362-409 — NEE for a surface point (`rpt_tpu/integrators/
    path.py:87`). ``mask`` marks lanes whose result is consumed; shadow
    queries are disabled on the rest. All lights' shadow rays run as one
    occlusion query; each light keeps its own RNG stream."""
    color = Vec3.zeros(pos.x.shape, pos.x.device)
    pending = []  # (wi, contrib, dist) per non-ambient light
    for li, (lstat, ltab) in enumerate(zip(scene.lights, tables["lights"])):
        if lstat.kind == "ambient":
            color = color + ltab["color"].broadcast_to(pos.shape) * mat.color_query()
            continue
        intensity, wi, dist = illuminate(lstat, ltab, pos, sampling.fold(keys, 0x1100 + li))
        f = bsdf(mat, n, wo, wi)
        pending.append((wi, f * intensity * wi.dot(n), dist))
    zero = Vec3.zeros(pos.x.shape, pos.x.device)
    for visible, (_, contrib, _) in zip(_shadow_visible_batch(scene, tables, pos, pending, mask),
                                        pending):
        color = color + where(visible, contrib, zero)
    return color


def sample_lights_for_media(scene, tables, medium, pos: Vec3, wo: Vec3, keys, mask=None) -> Vec3:
    """renderer.rs:325-359 — NEE for a medium scattering point
    (`rpt_tpu/integrators/path.py:123`): the light's intensity times the
    medium colour, the scattering albedo and the phase function, with the
    same batched shadow query and per-light RNG streams as `sample_lights`."""
    scat = medium.scattering(pos)
    ext = medium.extinction(pos)
    medium_color = medium.color(pos)
    color = Vec3.zeros(pos.x.shape, pos.x.device)
    pending = []
    for li, (lstat, ltab) in enumerate(zip(scene.lights, tables["lights"])):
        if lstat.kind == "ambient":
            color = color + ltab["color"].broadcast_to(pos.shape) * medium_color
            continue
        intensity, wi, dist = illuminate(lstat, ltab, pos, sampling.fold(keys, 0x1100 + li))
        ph = medium.phase(wo, wi)
        pending.append((wi, intensity * medium_color * ((scat / ext) * ph), dist))
    zero = Vec3.zeros(pos.x.shape, pos.x.device)
    for visible, (_, contrib, _) in zip(_shadow_visible_batch(scene, tables, pos, pending, mask),
                                        pending):
        color = color + where(visible, contrib, zero)
    return color


def _shadow_visible(scene, tables, pos: Vec3, wi: Vec3, dist, mask=None):
    """True where no occluder lies strictly between ``pos`` and the light
    (`rpt_tpu/integrators/path.py:149`). Lanes with ``mask`` False get
    limit -1, which every traversal rejects at entry. With ``nee_mode ==
    "exact"``, the closest hit must lie at the light distance instead."""
    if scene.nee_mode == "exact":
        hit = closest_hit(scene, tables, Ray(pos, wi))
        ok = hit.valid & (torch.abs(hit.time - dist) < scene.shadow_eps * dist)
        return ok if mask is None else ok & mask
    limit = dist * (1.0 - scene.shadow_eps)
    if mask is not None:
        limit = torch.where(mask, limit, -1.0)
    return ~occluded(scene, tables, Ray(pos, wi), limit)


def _shadow_visible_batch(scene, tables, pos: Vec3, pending, mask):
    """Visibility of every light's shadow ray from the same points,
    concatenated into one occlusion wavefront of n * L lanes
    (`rpt_tpu/integrators/path.py:171`); lanes with a zero contribution
    are gated off. The exact-NEE mode queries light by light."""
    if not pending:
        return []
    if scene.nee_mode == "exact":
        return [_shadow_visible(scene, tables, pos, wi, dist, mask) for wi, _, dist in pending]
    n = pos.x.shape[0]
    bpos = Vec3(*(torch.cat([getattr(pos, c)] * len(pending)) for c in "xyz"))
    bwi = Vec3(*(torch.cat([getattr(wi, c) for wi, _, _ in pending]) for c in "xyz"))
    limits = []
    for _, contrib, dist in pending:
        lmask = _nonzero_contrib(contrib)
        if mask is not None:
            lmask = lmask & mask
        limits.append(torch.where(lmask, dist * (1.0 - scene.shadow_eps), -1.0))
    occ = occluded(scene, tables, Ray(bpos, bwi), torch.cat(limits))
    return [~occ[i * n:(i + 1) * n] for i in range(len(pending))]


def trace_surface(scene, tables, ray: Ray, keys, max_bounces: int, return_stats: bool = False):
    """Radiance of a wavefront of camera rays with no participating media
    (`rpt_tpu/integrators/path.py:219`, default schedule). ``keys`` are the
    (n, 2) per-lane trace keys (a tensor or a `sampling.KeyPath`; each
    draw derives its key from them in its own launch). With
    ``return_stats``, also returns the number of traced ray segments
    (camera/bounce + shadow), as a 0-dim int64 tensor, for Mrays/s
    accounting."""
    keys = sampling.key_path(keys)
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    materials = tables["materials"]
    n_shadow = sum(1 for light in scene.lights if light.kind != "ambient")
    zero = Vec3.zeros(n, dev)
    dead_pos, dead_dir = _dead_ray_fields(n, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    contribs, factors = [], []
    for b in range(max_bounces + 1):
        kb = sampling.fold(keys, b)
        hit = closest_hit(scene, tables, ray)
        hitmask = alive & hit.valid
        missmask = alive & ~hit.valid

        mat = materials.lookup(hit.material)
        pos = _sanitize(ray.at(hit.time), hitmask)
        wo = -ray.dir.normalize()
        if b == 0:  # emission only at bounce 0 (renderer.rs:295-299)
            emit = where(hitmask, mat.color_query() * mat.emittance_query(), zero)
        else:
            emit = zero
        nee = sample_lights(scene, tables, mat, pos, hit.normal, wo, sampling.fold(kb, 2),
                            mask=hitmask)
        env = scene.env_color(tables, ray.dir)
        contribs.append(emit + where(hitmask, nee, zero) + where(missmask, env, zero))

        wi, pdf, valid = sample_f(mat, hit.normal, wo, sampling.fold(kb, 3))
        f = bsdf(mat, hit.normal, wo, wi)
        bounce_ok = hitmask & valid & (b < max_bounces)
        factor = f * (torch.abs(wi.dot(hit.normal)) / torch.clamp(pdf, min=1e-20))
        factors.append(where(bounce_ok, factor, zero))
        segments = segments + alive.sum() + hitmask.sum() * n_shadow

        ray = Ray(where(bounce_ok, pos, dead_pos), where(bounce_ok, wi, dead_dir))
        alive = bounce_ok

    # backward clamp fold: L_b = contrib_b + min(factor_b * L_{b+1}, 100)
    radiance = zero
    for contrib, factor in zip(reversed(contribs), reversed(factors)):
        radiance = contrib + (factor * radiance).map(lambda c: torch.clamp(c, max=FIREFLY_CLAMP))
    if return_stats:
        return radiance, segments
    return radiance


def trace_volumetric(scene, tables, ray: Ray, keys, max_depth: int = 32,
                     return_stats: bool = False):
    """Radiance of a wavefront of camera rays in a scene with a
    participating medium (``scene.media[0]`` only, as the reference's TODO
    at renderer.rs:189; `rpt_tpu/integrators/path.py:504`). ``keys`` are the
    (n, 2) per-lane trace keys (a tensor or a `sampling.KeyPath`, indexed
    with the survivors). With ``return_stats``, also returns the number of
    traced ray segments as a 0-dim int64 tensor: per level the live lanes
    plus one shadow segment per non-ambient light for every medium or
    surface event."""
    keys = sampling.key_path(keys)
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    materials = tables["materials"]
    medium = scene.media[0]
    n_shadow = sum(1 for light in scene.lights if light.kind != "ambient")
    radiance = torch.zeros((n, 3), dtype=DTYPE, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    lane = torch.arange(n, device=dev)  # the output row of each live lane
    throughput = Vec3.ones(n, dev)
    for b in range(max_depth):
        nw = lane.shape[0]
        if nw == 0:
            break
        zero = Vec3.zeros(nw, dev)
        kb = sampling.fold(keys, b)

        d, _, _ = medium.sample_d(ray, sampling.fold(kb, 1))
        hit = closest_hit(scene, tables, ray)
        has_hit = hit.valid
        medium_event = d < torch.where(has_hit, hit.time, BACKGROUND_DIST)
        surface_event = ~medium_event & has_hit
        escape_event = ~medium_event & ~has_hit

        wo = -ray.dir.normalize()
        collision = _sanitize(ray.at(d), medium_event)
        surf_pos = _sanitize(ray.at(hit.time), surface_event)
        mat = materials.lookup(hit.material)

        # ---- emission (level 0 only), environment, NEE --------------------
        med_color_c = medium.color(collision)
        contrib = where(escape_event & (d >= BACKGROUND_DIST),
                        scene.env_color(tables, ray.dir), zero)
        if b == 0:
            contrib = (contrib
                       + where(surface_event, mat.color_query() * mat.emittance_query(), zero)
                       + where(medium_event, med_color_c * medium.emission(collision), zero))
        # one shared shadow origin: its position depends on the event kind
        nee_pos = where(medium_event, collision, surf_pos)
        nee_surf = sample_lights(scene, tables, mat, nee_pos, hit.normal, wo,
                                 sampling.fold(kb, 2), mask=surface_event)
        nee_med = sample_lights_for_media(scene, tables, medium, nee_pos, wo,
                                          sampling.fold(kb, 3), mask=medium_event)
        contrib = contrib + where(surface_event, nee_surf, zero) + where(medium_event, nee_med,
                                                                         zero)
        radiance[lane] += (throughput * contrib).to_array()
        segments = segments + nw + (medium_event | surface_event).sum() * n_shadow

        # ---- Russian roulette continuation (p = 0.8) ----------------------
        survive = sampling.uniform(sampling.fold(kb, 4)) < RR_P
        # surface continuation (renderer.rs:222-234)
        wi_s, pdf_s, valid_s = sample_f(mat, hit.normal, wo, sampling.fold(kb, 5))
        f = bsdf(mat, hit.normal, wo, wi_s)
        surf_factor = f * (torch.abs(wi_s.dot(hit.normal))
                           / (torch.clamp(pdf_s, min=1e-20) * RR_P))
        # medium continuation (renderer.rs:262-281)
        scat_c = medium.scattering(collision)
        ext_c = medium.absorption(collision) + scat_c
        wi_m, ph_p = medium.sample_ph(wo, sampling.fold(kb, 6))
        ph = medium.phase(wo, wi_m)
        med_factor = med_color_c * ((scat_c / ext_c) * ph / (torch.clamp(ph_p, min=1e-20) * RR_P))

        cont = survive & (medium_event | (surface_event & valid_s))
        throughput = throughput * where(medium_event, med_factor, surf_factor)
        # the lanes that go on, compacted in lane order
        sel = torch.nonzero(cont).squeeze(1)
        ray = Ray(where(medium_event, collision, surf_pos)[sel],
                  where(medium_event, wi_m, wi_s)[sel])
        throughput = throughput.broadcast_to((nw,))[sel]
        keys = keys[sel]
        lane = lane[sel]
    out = Vec3(radiance[:, 0], radiance[:, 1], radiance[:, 2])
    if return_stats:
        return out, segments
    return out
