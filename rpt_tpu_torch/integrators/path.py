"""Wavefront path tracing, surface branch — port of
`rpt_tpu/integrators/path.py` (`rpt/src/renderer.rs:286-321`).

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

Not ported: the JAX package's pooled schedule (``POOLED_SCHEDULE``,
``mixed_closest_occluded``), which is TPU scheduling, and the media
branch ``trace_volumetric``.
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
    (n, 2) per-lane trace keys. With ``return_stats``, also returns the
    number of traced ray segments (camera/bounce + shadow), as a 0-dim
    int64 tensor, for Mrays/s accounting."""
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
