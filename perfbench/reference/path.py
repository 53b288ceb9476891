"""The plain reference path tracer: the radiance of chosen (pixel, sample)
pairs of a progressive render, in plain torch operations, computed from
the scene description alone.

It follows rpt's documented semantics (`renderer.rs:188-425`,
`material.rs`, `light.rs`, `medium.rs`) as the port states them: one
camera ray a pixel sample, jittered inside the pixel, each lane's random
numbers drawn from ``fold_in(fold_in(key(seed), pixel), sample)`` by
purpose tags; surface paths with next-event estimation at every hit and
the firefly clamp of 100 folded back over the levels; in a medium,
free-flight sampling, phase sampling, next-event estimation from surfaces
and from the medium, and Russian roulette. Intersection is exact over
every triangle of the clusters a ray enters (`reference.scene`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .scene import LAMBERTIAN, RefScene, apply, cross, dot, normalize

FIREFLY_CLAMP = 100.0  # renderer.rs:18
BACKGROUND_DIST = 400.0  # renderer.rs:199
RR_P = 0.8  # renderer.rs:193
EPS32 = float(np.finfo(np.float32).eps)
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi
INV_4PI = 1.0 / (4.0 * math.pi)
INF = float("inf")
BOX_TESTS = 1 << 22  # (ray, cluster box) tests a block, of 2048 rays at least
PAIR_CHUNK = 1 << 16  # (ray, cluster) pairs a block of triangle tests


def _uniforms(keys, tags, count, dtype, lo=0.0, hi=1.0):
    return [u.to(dtype) for u in rng.uniforms(rng.fold_chain(keys, *tags), count, lo, hi)]


def at(o, d, t):
    """o + d t, each component rounded once from float64 (`shape.rs:60-62`)."""
    return (o.double() + d.double() * t.double()[:, None]).to(o.dtype)


# -- intersection ----------------------------------------------------------------
class Hits:
    def __init__(self, t, normal, mat):
        self.t, self.normal, self.mat = t, normal, mat

    @property
    def valid(self):
        return torch.isfinite(self.t)


def _tri_test(sc: RefScene, o, d, ids, limit):
    """(pairs, slots) times of the triangles ``ids`` (-1 pads) along rays
    (o, d), inf where missed or not under ``limit``; and their
    barycentrics u, v, w."""
    safe = ids.clamp(min=0)
    v1, e1, e2, pn = sc.tri_v1[safe], sc.tri_e1[safe], sc.tri_e2[safe], sc.tri_pn[safe]
    o, d = o[:, None, :], d[:, None, :]
    cosine = dot(pn, d)
    num = dot(pn, v1 - o)
    t = num / cosine
    size = o.abs().sum(-1) + v1.abs().sum(-1)
    ok = ((cosine.abs() >= 1e-8) & ~(num.abs() <= (32.0 * EPS32) * size) & (t >= sc.t_min)
          & (t < limit[:, None]) & (ids >= 0))
    p = o + d * t[..., None]
    d2 = p - v1
    d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    d20, d21 = dot(d2, e1), dot(d2, e2)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    ok = ok & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return torch.where(ok, t, INF), u, v, w


def _tri_closest(sc: RefScene, o, d, limit):
    """The closest triangle of each ray under ``limit``: (t, triangle id,
    -1 for none). Every cluster box the ray enters below its current best
    is opened and all its triangles tested."""
    n = o.shape[0]
    best = limit.clone()
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if sc.n_tris == 0 or n == 0:
        return best, tri
    o32, inv32 = o.float(), 1.0 / d.float()
    step = max(2048, BOX_TESTS // sc.cl_lo.shape[0])
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        oo, ii = o32[r0:r1, None, :], inv32[r0:r1, None, :]
        t1 = (sc.cl_lo[None] - oo) * ii
        t2 = (sc.cl_hi[None] - oo) * ii
        tn = torch.nan_to_num(torch.minimum(t1, t2), nan=-INF).amax(-1)
        tf = torch.nan_to_num(torch.maximum(t1, t2), nan=INF).amin(-1)
        cand = (tn <= tf) & (tf >= sc.t_min) & (tn < best[r0:r1, None].float())
        ri, gi = cand.nonzero(as_tuple=True)
        for p0 in range(0, ri.numel(), PAIR_CHUNK):
            r = ri[p0:p0 + PAIR_CHUNK] + r0
            ids = sc.cl_members[gi[p0:p0 + PAIR_CHUNK]]
            t, _, _, _ = _tri_test(sc, o[r], d[r], ids, best[r])
            tp, slot = t.min(1)
            idp = ids.gather(1, slot[:, None])[:, 0]
            best.scatter_reduce_(0, r, tp, "amin")
            won = torch.isfinite(tp) & (tp == best[r])
            tri[r[won]] = idp[won]
    return best, tri


def _cube_hit(sc: RefScene, inv, nmat, o, d):
    lo_ = apply(inv, o)
    ld = apply(inv, d, point=False)
    x1, x2 = (-0.5 - lo_) / ld, (0.5 - lo_) / ld
    near, far = torch.minimum(x1, x2), torch.maximum(x1, x2)
    sign = torch.where(x1 > x2, 1.0, -1.0).to(o.dtype)
    nx, ny, nz = near.unbind(-1)
    fx, fy, fz = far.unbind(-1)
    x_first = (nx > ny) & (nx > nz)
    y_first = ~x_first & (ny > nz)
    z_first = ~(x_first | y_first)
    start = torch.where(x_first, nx, torch.where(y_first, ny, nz))
    start_n = torch.stack([x_first, y_first, z_first], -1).to(o.dtype) * sign
    x_last = (fx < fy) & (fx < fz)
    y_last = ~x_last & (fy < fz)
    z_last = ~(x_last | y_last)
    end = torch.where(x_last, fx, torch.where(y_last, fy, fz))
    end_n = -torch.stack([x_last, y_last, z_last], -1).to(o.dtype) * sign
    ok = (start <= end) & (end >= sc.t_min)
    inside = start < sc.t_min
    t = torch.where(inside, end, start)
    local_n = torch.where(inside[:, None], end_n, start_n)
    return torch.where(ok, t, INF), normalize(apply(nmat, local_n, point=False))


def _plane_hit(sc: RefScene, n, value, o, d):
    cosine = dot(n[None], d)
    num = value - dot(n[None], o)
    t = num / cosine
    size = n.abs().sum() * o.abs().sum(-1) + abs(value)
    ok = (cosine.abs() >= 1e-8) & (t >= sc.t_min) & ~(num.abs() <= (32.0 * EPS32) * size)
    normal = -normalize(n[None]).expand_as(o) * torch.sign(cosine)[:, None]
    return torch.where(ok, t, INF), normal


def closest(sc: RefScene, o, d, limit):
    """The closest hit of each ray with t in [t_min, limit): cubes, then
    planes (the first of equal times wins), then the triangles closer
    than those."""
    n = o.shape[0]
    best_t = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    best_n = torch.zeros_like(o)
    best_m = torch.zeros(n, dtype=torch.int64, device=o.device)
    prims = [(_cube_hit(sc, inv, nm, o, d), mid) for inv, nm, mid in sc.cubes]
    prims += [(_plane_hit(sc, nrm, v, o, d), mid) for nrm, v, mid in sc.planes]
    for (t, normal), mid in prims:
        take = t < best_t
        best_t = torch.where(take, t, best_t)
        best_n = torch.where(take[:, None], normal, best_n)
        best_m = torch.where(take, mid, best_m)
    best_t = torch.where(best_t < limit, best_t, INF)
    tt, tri = _tri_closest(sc, o, d, torch.minimum(limit, best_t))
    won = tri >= 0
    if bool(won.any()):
        lanes = won.nonzero()[:, 0]
        ids = tri[lanes][:, None]
        _, u, v, w = _tri_test(sc, o[lanes], d[lanes], ids, torch.full_like(tt[lanes], INF))
        nn = (sc.tri_n[0][ids[:, 0]] * u + sc.tri_n[1][ids[:, 0]] * v
              + sc.tri_n[2][ids[:, 0]] * w)
        best_t[lanes] = tt[lanes]
        best_n[lanes] = normalize(nn)
        best_m[lanes] = sc.tri_mat[ids[:, 0]]
    return Hits(best_t, best_n, best_m)


def occluded(sc: RefScene, o, d, limit):
    """True where some geometry lies at t in [t_min, limit)."""
    return closest(sc, o, d, limit).valid


# -- materials -------------------------------------------------------------------
def _basis(n):
    """Branchless orthonormal basis around a unit ``n`` (Duff et al. 2017)."""
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b, -sign * n[:, 0]], -1)
    u = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return t, u


def _from_local(lx, ly, lz, n):
    t, b = _basis(n)
    return t * lx[:, None] + n * ly[:, None] + b * lz[:, None]


def _reflect(v, n):
    return v - n * (2.0 * dot(v, n))[:, None]


def sample_f(kind, albedo, shine, normal, wo, keys):
    """A bounce direction and its pdf (`material.rs:166-263`), Lambertian
    and Phong lobes."""
    r1, r2 = _uniforms(keys, (0xB5DF,), 2, wo.dtype)
    phi = TWO_PI * r1
    cos_l = torch.sqrt(r2)
    sin_l = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    wi_l = normalize(_from_local(sin_l * torch.cos(phi), cos_l, sin_l * torch.sin(phi), normal))
    pdf_l = cos_l * INV_PI
    cos_p = r2 ** (1.0 / (shine + 1.0))
    sin_p = torch.sqrt(torch.clamp(1.0 - cos_p * cos_p, min=0.0))
    axis = -_reflect(wo, normal)
    wi_p = normalize(_from_local(sin_p * torch.cos(phi), cos_p, sin_p * torch.sin(phi), axis))
    pdf_p = (shine + 1.0) / TWO_PI * cos_p**shine
    lam = kind == LAMBERTIAN
    return torch.where(lam[:, None], wi_l, wi_p), torch.where(lam, pdf_l, pdf_p)


def bsdf(kind, albedo, shine, normal, wo, wi):
    """`material.rs:266-289`: zero unless both directions are above."""
    above = (dot(normal, wi) >= 0.0) & (dot(normal, wo) >= 0.0)
    f_lam = albedo * INV_PI
    refl = normalize(-_reflect(wi, normal))
    f_phong = (albedo * ((shine + 2.0) / TWO_PI)[:, None]
               * (torch.clamp(dot(refl, wo), 0.0, 1.0) ** shine)[:, None])
    f = torch.where((kind == LAMBERTIAN)[:, None], f_lam, f_phong)
    return torch.where(above[:, None], f, 0.0)


# -- lights ----------------------------------------------------------------------
def _sample_light(light, pos, keys):
    """A point on the light for each shading point: (point, normal, pdf)."""
    dt = pos.dtype
    if light["kind"] == "sphere":
        target = normalize(apply(light["inv"], pos))
        r1, r2 = _uniforms(keys, (0x5A1,), 2, dt)
        r = torch.sqrt(r1)
        x, y = r * torch.cos(TWO_PI * r2), r * torch.sin(TWO_PI * r2)
        z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
        zero = torch.zeros_like(x)
        use_x = target[:, 0].abs() > 1e-12
        n1 = normalize(torch.where(use_x[:, None],
                                   torch.stack([target[:, 1], -target[:, 0], zero], -1),
                                   torch.stack([zero, -target[:, 2], target[:, 1]], -1)))
        n2 = cross(n1, target)
        p = n1 * x[:, None] + n2 * y[:, None] + target * z[:, None]
        world_n = normalize(apply(light["nmat"], p, point=False))
        height = dot(apply(light["fwd"][:, :3], p, point=False), world_n)
        return apply(light["fwd"], p), world_n, (z * INV_PI) / (light["det"] / height)
    count = light["count"]
    (u_idx,), (u,), (v,) = (_uniforms(keys, (tag,), 1, dt) for tag in (0x731, 0x732, 0x733))
    idx = torch.clamp((u_idx.float() * count).to(torch.int64), 0, count - 1)
    over = u + v > 1.0
    u, v = torch.where(over, 1.0 - u, u), torch.where(over, 1.0 - v, v)
    w = 1.0 - u - v
    (v1, v2, v3), (n1, n2, n3) = light["v"], light["n"]
    point = v1[idx] * u[:, None] + v2[idx] * v[:, None] + v3[idx] * w[:, None]
    normal = normalize(n1[idx] * u[:, None] + n2[idx] * v[:, None] + n3[idx] * w[:, None])
    return point, normal, 1.0 / (light["area"][idx] * count)


def _illuminate(light, pos, keys):
    """(intensity, direction to the light, distance) (`light.rs:22-47`)."""
    v, n, p = _sample_light(light, pos, keys)
    disp = v - pos
    dist = torch.sqrt(dot(disp, disp))
    cosine = torch.clamp(-dot(disp, n), min=0.0) / dist
    area = torch.clamp(cosine, min=0.0) / (dist * dist)
    return light["emit"][None] * (area / p)[:, None], disp / dist[:, None], dist


def _nee(sc: RefScene, pos, keys, scatter, ambient_color):
    """Next-event estimation from ``pos``: ``scatter(wi)`` weighs each
    light's sample; a light counts where its contribution is not zero and
    no geometry lies strictly closer than it."""
    color = torch.zeros_like(pos)
    for li, light in enumerate(sc.lights):
        if light["kind"] == "ambient":
            color = color + light["color"][None] * ambient_color
            continue
        intensity, wi, dist = _illuminate(light, pos, rng.fold_in(keys, 0x1100 + li))
        contrib = scatter(intensity, wi)
        live = (contrib != 0.0).any(-1)
        limit = torch.where(live, dist * (1.0 - sc.shadow_eps), -INF)
        color = color + torch.where((live & ~occluded(sc, pos, wi, limit))[:, None], contrib, 0.0)
    return color


# -- the camera and the integrators ---------------------------------------------
def camera_rays(sc: RefScene, pixels, samples, seed, base=None):
    """The camera ray and trace keys of each (pixel, sample) lane, from the
    key of ``seed`` or from the key ``base``."""
    dt, dev = sc.dtype, sc.device
    w, h = sc.width, sc.height
    dim = float(max(w, h))
    px, py = (pixels % w).double(), (pixels // w).double()
    xn = ((2.0 * px + 1.0 - w) / dim).to(torch.float32).to(dt)
    yn = ((2.0 * (h - py) - 1.0 - h) / dim).to(torch.float32).to(dt)
    base = rng.key(seed, dev) if base is None else base
    keys = rng.fold_in(rng.fold_in(base, pixels), samples)
    (jx,), (jy,) = (_uniforms(keys, (tag,), 1, dt, -1.0 / dim, 1.0 / dim) for tag in (1, 2))
    x, y = xn + jx, yn + jy
    direction = (sc.cam_fwd * sc.cam_d)[None] + sc.cam_right[None] * x[:, None] \
        + sc.cam_up[None] * y[:, None]
    origin = sc.cam_eye[None].expand(len(x), 3)
    return origin, normalize(direction), rng.fold_in(keys, 4)


def trace_surface(sc: RefScene, o, d, keys):
    """`renderer.rs:288-321` over levels: emission at level 0, NEE at every
    hit, and L_b = contrib_b + min(factor_b L_(b+1), 100) folded back."""
    n = o.shape[0]
    lanes = torch.arange(n, device=o.device)
    contribs, factors = [], []
    for b in range(sc.max_bounces + 1):
        kb = rng.fold_in(keys, b)
        hit = closest(sc, o, d, torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device))
        ok = hit.valid
        contrib = torch.zeros((n, 3), dtype=o.dtype, device=o.device)  # black environment
        hl = ok.nonzero()[:, 0]
        kind, albedo = sc.mat_kind[hit.mat[hl]], sc.mat_albedo[hit.mat[hl]]
        shine, emit = sc.mat_shine[hit.mat[hl]], sc.mat_emit[hit.mat[hl]]
        pos = at(o[hl], d[hl], hit.t[hl])
        normal = hit.normal[hl]
        wo = -normalize(d[hl])
        c = torch.zeros_like(pos)
        if b == 0:
            c = c + albedo * emit[:, None]

        def surface(intensity, wi):
            f = bsdf(kind, albedo, shine, normal, wo, wi)
            return f * intensity * dot(wi, normal)[:, None]

        c = c + _nee(sc, pos, rng.fold_in(kb[hl], 2), surface, albedo)
        contrib[lanes[hl]] = c
        contribs.append(contrib)
        factor = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
        if b < sc.max_bounces:
            wi, pdf = sample_f(kind, albedo, shine, normal, wo, rng.fold_in(kb[hl], 3))
            f = bsdf(kind, albedo, shine, normal, wo, wi)
            factor[lanes[hl]] = f * (dot(wi, normal).abs() / torch.clamp(pdf, min=1e-20))[:, None]
            o, d, keys, lanes = pos, wi, keys[hl], lanes[hl]
        factors.append(factor)
        if b == sc.max_bounces:
            break
    radiance = torch.zeros_like(contribs[0])
    for contrib, factor in zip(reversed(contribs), reversed(factors)):
        radiance = contrib + torch.clamp(factor * radiance, max=FIREFLY_CLAMP)
    return radiance


def trace_volumetric(sc: RefScene, o, d, keys):
    """`renderer.rs:188-285`: per level a free flight against the closest
    hit picks a medium event, a surface event or an escape; NEE from the
    event; radiance accumulates forwards; Russian roulette (p = 0.8)."""
    med = sc.medium
    dt, dev = sc.dtype, sc.device
    n = o.shape[0]
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    lane = torch.arange(n, device=dev)
    through = torch.ones((n, 3), dtype=dt, device=dev)
    sig_a = torch.tensor(med["absorption"], dtype=torch.float32, device=dev).to(dt)
    sig_s = torch.tensor(med["scattering"], dtype=torch.float32, device=dev).to(dt)
    ext = sig_a + sig_s
    mcol = med["color"][None]
    for b in range(sc.media_depth):
        m = lane.shape[0]
        if m == 0:
            break
        kb = rng.fold_in(keys, b)
        (u,) = _uniforms(kb, (1, 0x5D), 1, dt)
        dist = -torch.log(torch.clamp(u, min=1e-38)) / ext
        hit = closest(sc, o, d, torch.full((m,), INF, dtype=dt, device=dev))
        medium_ev = dist < torch.where(hit.valid, hit.t, BACKGROUND_DIST)
        surface_ev = ~medium_ev & hit.valid
        wo = -normalize(d)
        contrib = torch.zeros((m, 3), dtype=dt, device=dev)  # escapes see the black environment
        mat = hit.mat
        kind, albedo, shine = sc.mat_kind[mat], sc.mat_albedo[mat], sc.mat_shine[mat]
        pos = torch.where(medium_ev[:, None], at(o, d, dist),
                          at(o, d, torch.where(surface_ev, hit.t, 0.0)))
        if b == 0:
            contrib = contrib + torch.where(surface_ev[:, None], albedo * sc.mat_emit[mat][:, None],
                                            0.0)
        # NEE: from surfaces (fold 2) and from the medium (fold 3)
        s = surface_ev.nonzero()[:, 0]
        ks, ns, ws = kind[s], albedo[s], shine[s]
        nrm, wos = hit.normal[s], wo[s]

        def surface(intensity, wi):
            return bsdf(ks, ns, ws, nrm, wos, wi) * intensity * dot(wi, nrm)[:, None]

        contrib[s] = contrib[s] + _nee(sc, pos[s], rng.fold_in(kb[s], 2), surface, ns)
        md = medium_ev.nonzero()[:, 0]

        def in_medium(intensity, wi):
            return intensity * mcol * ((sig_s / ext) * INV_4PI)

        contrib[md] = contrib[md] + _nee(sc, pos[md], rng.fold_in(kb[md], 3), in_medium, mcol)
        radiance.index_add_(0, lane, through * contrib)
        # continuation
        (rr,) = _uniforms(kb, (4,), 1, dt)
        survive = rr < RR_P
        wi = torch.zeros_like(d)
        factor = torch.zeros_like(d)
        ok_s = torch.zeros_like(survive)
        if s.numel():
            wi_s, pdf_s = sample_f(ks, ns, ws, nrm, wos, rng.fold_in(kb[s], 5))
            f = bsdf(ks, ns, ws, nrm, wos, wi_s)
            wi[s] = wi_s
            factor[s] = f * (dot(wi_s, nrm).abs() / (torch.clamp(pdf_s, min=1e-20) * RR_P))[:, None]
            ok_s[s] = True
        if md.numel():
            r1, r2 = _uniforms(kb[md], (6, 0x9A), 2, dt)
            z = 1.0 - 2.0 * r1
            rad = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
            phi = TWO_PI * r2
            wi[md] = torch.stack([rad * torch.cos(phi), z, rad * torch.sin(phi)], -1)
            factor[md] = mcol * ((sig_s / ext) * INV_4PI / (INV_4PI * RR_P))
            ok_s[md] = True
        go = (survive & ok_s).nonzero()[:, 0]
        through = (through * factor)[go]
        o, d, keys, lane = pos[go], wi[go], keys[go], lane[go]
    return radiance


def radiance(desc: dict, seed: int, pixels, samples, device, dtype=torch.float32, block=8192):
    """The float32 radiance (mean of one sample, exposure applied) of each
    (pixel, sample index) pair of a render of ``desc`` seeded with
    ``seed``, in blocks of ``block`` lanes."""
    sc = RefScene(desc, device, dtype)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    samples = torch.as_tensor(samples, dtype=torch.int64, device=device)
    out = []
    for b0 in range(0, pixels.shape[0], block):
        o, d, keys = camera_rays(sc, pixels[b0:b0 + block], samples[b0:b0 + block], seed)
        trace = trace_volumetric if sc.medium is not None else trace_surface
        out.append(trace(sc, o, d, keys).float() * sc.exposure)
    return torch.cat(out).cpu().numpy()
