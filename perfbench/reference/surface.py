"""The plain reference for surface paths through glass under a sky: the
radiance of chosen (pixel, sample) pairs of a progressive render with no
medium, in plain torch operations, from the scene description alone.

It is `reference.path.trace_surface` with two additions, as the port
states rpt's semantics:

* the transmissive material (`material.rs:166-263`): Schlick's ratio
  taken from the side the ray is on, a drawn choice between reflection
  and refraction (purpose tags 0xB5DF for the lobe draws, 0xF7E5 for the
  choice, as every material draws them), total internal reflection
  ending the path, and f = 1 and pdf 1, with the bsdf's rule that f is 0
  unless both directions lie above the surface (so a refracted ray
  carries nothing back: the port's, and the JAX package's, quirk);
* an equirectangular sky (`environment.rs:25-52`): a ray that escapes
  adds the sky's colour where `trace_surface` adds black. The lookup is
  bilinear with ``x0`` and ``y0`` truncated toward zero, and ``x0 + 1``,
  ``y0 + 1`` clamped to the last column and row (no wrap at the seam),
  as the port has it: reproduced, not mended.

Next-event estimation runs at every hit, transmissive ones included,
with the bsdf's f = 1, as rpt's ``trace_ray`` and the port run it
(``is_mirror`` gates the photon path's deposits, not this); the pegasus
has no light, so it adds nothing there. The roughness of
``transparent`` is ignored, as the port ignores it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .path import FIREFLY_CLAMP, _nee, _reflect, _uniforms, at, camera_rays, closest
from .path import bsdf as _lobes_bsdf
from .path import sample_f as _lobes_sample_f
from .scene import RefScene, dot, normalize

TRANSMISSIVE = 3  # material.rs:8-23: Lambertian 0, Phong 1, Mirror 2, Transmissive 3


class SurfaceScene(RefScene):
    """`RefScene` with the transparent material (a row's fifth entry is its
    index of refraction) and the environment map (``desc["environment"]``:
    an equirectangular (H, W, 3) ``map``)."""

    def __init__(self, desc: dict, device, dtype=torch.float32):
        super().__init__(desc, device, dtype)
        self.mat_ior = self._t([m[4] if len(m) > 4 else 1.0 for m in self._materials])
        sky = np.asarray(desc["environment"]["map"], np.float64)
        self.sky_h, self.sky_w = sky.shape[:2]
        self.sky = self._t(sky.reshape(-1, 3))

    def _material(self, m: dict) -> int:
        if m["kind"] != "transparent":
            return super()._material(m)
        # its colour reads black, as for every kind but the two lobes (material.rs:100-141)
        row = (TRANSMISSIVE, (0.0, 0.0, 0.0), 0.0, 0.0, float(m["ior"]))
        if row not in self._materials:
            self._materials.append(row)
        return self._materials.index(row)


def sky_color(sc: SurfaceScene, d):
    """The environment's colour in the directions ``d`` (n, 3)."""
    # each component contiguous: the CPU's vectorised atan2 and acos round
    # apart from its strided ones, and the port holds the three apart
    dx, dy, dz = (c.contiguous() for c in normalize(d).unbind(-1))
    w, h = sc.sky_w, sc.sky_h
    azimuth = torch.atan2(dz, dx) + math.pi
    polar = torch.acos(torch.clamp(dy, -1.0, 1.0))
    x = azimuth / (2.0 * math.pi) * (w - 1)
    y = polar / math.pi * (h - 1)
    x0 = torch.clamp(x.to(torch.int32), 0, w - 1)
    y0 = torch.clamp(y.to(torch.int32), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    ax = (x - x0.to(x.dtype))[:, None]
    ay = (y - y0.to(y.dtype))[:, None]

    def fetch(yy, xx):
        return sc.sky[(yy * w + xx).long()]

    def lerp(a, b, t):
        return a + (b - a) * t

    return lerp(lerp(fetch(y0, x0), fetch(y0, x1), ax), lerp(fetch(y1, x0), fetch(y1, x1), ax), ay)


def _schlick(ni, nt, cos_i):
    """material.rs:159-162."""
    r0 = ((ni - nt) / (ni + nt)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def sample_f(kind, albedo, shine, ior, normal, wo, keys):
    """A bounce direction, its pdf and whether it exists (False on total
    internal reflection): Lambertian and Phong lobes as `reference.path`,
    the transmissive bounce of `material.rs:166-263`."""
    wi, pdf = _lobes_sample_f(kind, albedo, shine, normal, wo, keys)
    (rr,) = _uniforms(keys, (0xF7E5,), 1, wo.dtype)
    inside = dot(normal, wo) < 0.0
    n_eff = torch.where(inside[:, None], -normal, normal)
    cos_i = torch.clamp(dot(wo, n_eff), 0.0, 1.0)
    one = torch.ones_like(cos_i)
    ni, nt = torch.where(inside, ior, one), torch.where(inside, one, ior)
    reflect_branch = rr < torch.clamp(_schlick(ni, nt, cos_i), 0.0, 1.0)
    eta = ni / nt
    disc = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(disc, min=0.0))
    refracted = -wo * eta[:, None] + n_eff * (eta * cos_i - cos_t)[:, None]
    wi_t = torch.where(reflect_branch[:, None], -_reflect(wo, normal), refracted)
    glass = kind == TRANSMISSIVE
    ok = ~glass | reflect_branch | ~(disc < 0.0)
    return torch.where(glass[:, None], wi_t, wi), torch.where(glass, one, pdf), ok


def bsdf(kind, albedo, shine, normal, wo, wi):
    """`material.rs:266-289`: the lobes as `reference.path`, 1 for the
    transmissive material; zero unless both directions are above."""
    f = _lobes_bsdf(kind, albedo, shine, normal, wo, wi)
    above = (dot(normal, wi) >= 0.0) & (dot(normal, wo) >= 0.0)
    glass = ((kind == TRANSMISSIVE) & above)[:, None]
    return torch.where(glass, torch.ones_like(f), f)


def trace_surface(sc: SurfaceScene, o, d, keys):
    """`renderer.rs:288-321` over levels: the sky where a ray escapes,
    emission at level 0, NEE at every hit, and L_b = contrib_b +
    min(factor_b L_(b+1), 100) folded back; a path ends where its bounce
    does not exist."""
    n = o.shape[0]
    lanes = torch.arange(n, device=o.device)
    contribs, factors = [], []
    for b in range(sc.max_bounces + 1):
        kb = rng.fold_in(keys, b)
        hit = closest(sc, o, d, torch.full((o.shape[0],), math.inf, dtype=o.dtype,
                                           device=o.device))
        ok = hit.valid
        contrib = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
        miss = (~ok).nonzero()[:, 0]
        contrib[lanes[miss]] = sky_color(sc, d[miss])
        hl = ok.nonzero()[:, 0]
        mat = hit.mat[hl]
        kind, albedo, shine = sc.mat_kind[mat], sc.mat_albedo[mat], sc.mat_shine[mat]
        pos = at(o[hl], d[hl], hit.t[hl])
        normal = hit.normal[hl]
        wo = -normalize(d[hl])
        c = torch.zeros_like(pos)
        if b == 0:
            c = c + albedo * sc.mat_emit[mat][:, None]

        def surface(intensity, wi):
            return bsdf(kind, albedo, shine, normal, wo, wi) * intensity * dot(wi, normal)[:, None]

        contrib[lanes[hl]] = c + _nee(sc, pos, rng.fold_in(kb[hl], 2), surface, albedo)
        contribs.append(contrib)
        factor = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
        factors.append(factor)
        if b == sc.max_bounces:
            break
        wi, pdf, exists = sample_f(kind, albedo, shine, sc.mat_ior[mat], normal, wo,
                                   rng.fold_in(kb[hl], 3))
        f = bsdf(kind, albedo, shine, normal, wo, wi)
        go = exists.nonzero()[:, 0]
        factor[lanes[hl[go]]] = (f * (dot(wi, normal).abs()
                                      / torch.clamp(pdf, min=1e-20))[:, None])[go]
        o, d, keys, lanes = pos[go], wi[go], keys[hl[go]], lanes[hl[go]]
    radiance = torch.zeros_like(contribs[0])
    for contrib, factor in zip(reversed(contribs), reversed(factors)):
        radiance = contrib + torch.clamp(factor * radiance, max=FIREFLY_CLAMP)
    return radiance


def radiance(desc: dict, seed: int, pixels, samples, device, dtype=torch.float32, block=8192):
    """The float32 radiance (mean of one sample, exposure applied) of each
    (pixel, sample index) pair of a render of ``desc`` seeded with
    ``seed``, in blocks of ``block`` lanes."""
    sc = SurfaceScene(desc, device, dtype)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    samples = torch.as_tensor(samples, dtype=torch.int64, device=device)
    out = []
    for b0 in range(0, pixels.shape[0], block):
        o, d, keys = camera_rays(sc, pixels[b0:b0 + block], samples[b0:b0 + block], seed)
        out.append(trace_surface(sc, o, d, keys).float() * sc.exposure)
    return torch.cat(out).cpu().numpy()
