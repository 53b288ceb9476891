"""The plain reference of the point-photon x beam-query photon mapping
render (`photon.rs:185-985`): the image at chosen pixels of a render of a
scene description seeded with ``seed``, in plain torch operations, with
nothing taken from the port.

* The shoot (`photon.rs:655-946`): photons leave the first light that is
  an object, from a point drawn on it, into the uniform hemisphere around
  its normal, each with the light's colour times ``watts`` over the
  photons emitted; in equal chunks of at most 2^19, chunk ``c`` keyed
  ``fold_in(key, c * chunk)`` and photon ``i`` of it ``fold_in(that, i)``.
  At each level a free flight against the closest hit decides a medium
  event (a deposit, then scattering with probability sigma_s / sigma_t,
  the power times colour x albedo / phase pdf x phase) or a surface event
  (scattering with probability 0.7, a deposit on that branch, the power
  times f |cos| / (pdf 0.7), the cosine taken as 1 below the surface).
  A deposit keeps the position, the direction back, the power before the
  event and the segment's start.
* The map: each volume photon becomes a sphere whose radius is the
  distance to its 10th nearest volume photon, itself included.
* The camera pass (`photon.rs:439-627`), for each sample: the camera ray;
  the volume estimate, every sphere whose centre lies ahead of the ray,
  within its radius of the ray and no farther from the origin than the
  ray's hit, weighted by the blur kernel (3/pi)(1 - d^2/r^2)^2 / r^2, the
  transmittance to the centre's foot and the phase, times the medium's
  colour; plus the surface estimate at the hit, attenuated: the 20
  nearest surface photons, each that is not occluded from the hit
  weighed by the BSDF and its cosine, with the surface's own emission,
  over the disk of the 20th distance.

The k nearest neighbours come from `knn`, an exact search over uniform
grids that coarsen until each query's k-th distance lies inside the block
of cells it searched.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from . import rng
from .path import INF, INV_4PI, TWO_PI, _from_local, _sample_light, at, bsdf, camera_rays, \
    closest, occluded, sample_f, _uniforms
from .scene import RefScene, dot, normalize

MAX_DEPTH = 48  # the shoot's levels
CHUNK = 1 << 19  # photons a chunk of the shoot
P_DIFFUSE = 0.7  # the shoot's survival on surfaces (photon.rs:821-833)
RADIUS_K = 10  # a photon sphere's radius: the distance to its 10th nearest photon
PAIRS = 1 << 25  # (query, point) pairs a block of the k-NN
SWEEP_PAIRS = 1 << 26  # (ray, sphere) pairs a block of the volume estimate


# -- the shoot ---------------------------------------------------------------------
def _shoot_chunk(sc: RefScene, light, keys, power_scalar: float):
    """Deposits of one chunk of photons keyed ``keys`` (n, 2): (surface
    rows, volume rows), rows [position, direction back, power, start]."""
    dt, dev = sc.dtype, sc.device
    n = keys.shape[0]
    med = sc.medium
    sig_a = torch.tensor(med["absorption"], dtype=torch.float32, device=dev).to(dt)
    sig_s = torch.tensor(med["scattering"], dtype=torch.float32, device=dev).to(dt)
    ext = sig_a + sig_s
    rr_prob = sig_s / ext
    mcol = med["color"][None]
    zero = torch.zeros((n, 3), dtype=dt, device=dev)
    pos, nrm, _ = _sample_light(light, zero, rng.fold_in(keys, 1))
    r1, r2 = _uniforms(keys, (2,), 2, dt)
    phi = TWO_PI * r1
    cos_t = 1.0 - r2
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    d = normalize(_from_local(sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi), nrm))
    o = pos
    power = (light["color"] * power_scalar)[None].expand(n, 3)
    s_out, v_out = [], []
    for b in range(MAX_DEPTH):
        m = o.shape[0]
        if m == 0:
            break
        kb = rng.fold_in(keys, b)
        wo = -normalize(d)
        hit = closest(sc, o, d, torch.full((m,), INF, dtype=dt, device=dev))
        (u,) = _uniforms(kb, (1, 0x5D), 1, dt)
        dist = -torch.log(torch.clamp(u, min=1e-38)) / ext
        vol = dist < torch.where(hit.valid, hit.t, INF)
        collision = torch.where(vol[:, None], at(o, d, dist), 0.0)
        (u_v,) = _uniforms(kb, (2,), 1, dt)
        q1, q2 = _uniforms(kb, (3, 0x9A), 2, dt)
        z = 1.0 - 2.0 * q1
        rad = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = TWO_PI * q2
        wi_v = torch.stack([rad * torch.cos(phi), z, rad * torch.sin(phi)], -1)
        ph = torch.full_like(u_v, INV_4PI)
        vol_go = vol & (u_v < rr_prob)
        vol_power = power * mcol * (rr_prob * ph / torch.clamp(ph, min=1e-20))[:, None]
        surf = hit.valid & ~vol
        mat = hit.mat
        kind, albedo, shine = sc.mat_kind[mat], sc.mat_albedo[mat], sc.mat_shine[mat]
        spos = torch.where(surf[:, None], at(o, d, torch.where(surf, hit.t, 0.0)), 0.0)
        (u_s,) = _uniforms(kb, (4,), 1, dt)
        wi_s, pdf_s = sample_f(kind, albedo, shine, hit.normal, wo, rng.fold_in(kb, 5))
        f = bsdf(kind, albedo, shine, hit.normal, wo, wi_s)
        cos_raw = dot(wi_s, hit.normal)
        cosine = torch.where(cos_raw > 0.0, cos_raw, 1.0)
        surf_go = surf & (u_s < P_DIFFUSE)
        surf_power = power * f * (cosine / (torch.clamp(pdf_s, min=1e-20) * P_DIFFUSE))[:, None]
        dpos = torch.where(vol[:, None], collision, spos)
        rows = torch.cat([dpos, wo, power, o], dim=1)
        s_out.append(rows[surf_go])
        v_out.append(rows[vol])
        go = (vol_go | surf_go).nonzero()[:, 0]
        power = torch.where(vol[:, None], vol_power, surf_power)[go]
        d = torch.where(vol[:, None], wi_v, wi_s)[go]
        o, keys = dpos[go], keys[go]
    return torch.cat(s_out), torch.cat(v_out)


def shoot(sc: RefScene, key, count: int, watts: float):
    """All deposits of ``count`` photons (at least; equal chunks):
    (surface rows (S, 12), volume rows (V, 12)), in shoot order."""
    light = next(li for li in sc.lights if li["kind"] != "ambient")
    nchunks = max(1, -(-count // CHUNK))
    n_eq = -(-count // nchunks)
    power_scalar = watts / (nchunks * n_eq)
    surface, volume = [], []
    ids = torch.arange(n_eq, dtype=torch.int64, device=sc.device)
    for c in range(nchunks):
        keys = rng.fold_in(rng.fold_in(key, c * n_eq), ids)
        s, v = _shoot_chunk(sc, light, keys, power_scalar)
        surface.append(s[:4 * n_eq])  # the capacities: 4 deposits a photon on surfaces,
        volume.append(v[:10 * n_eq])  # 10 in the medium
    return torch.cat(surface), torch.cat(volume)


# -- k nearest neighbours ------------------------------------------------------------
def _cells(p, lo, size: float, g: int):
    c = torch.clamp(torch.floor((p.float() - lo) / size).to(torch.int64), 0, g - 1)
    return c, c[:, 0] + g * (c[:, 1] + g * c[:, 2])


def knn(points, queries, k: int):
    """The ``k`` nearest ``points`` of each query, exactly: (idx (m, k),
    d2 (m, k) ascending), d2 = dx^2 + dy^2 + dz^2 with d = point - query.
    Cells of uniform grids are tried from fine to coarse: a query takes
    the 3x3x3 block around its cell once the block holds k points, and
    keeps the answer once its k-th distance is under the cell's width (no
    point outside the block is nearer); else it tries the next grid."""
    m, dev = queries.shape[0], queries.device
    idx = torch.zeros((m, k), dtype=torch.int64, device=dev)
    d2 = torch.zeros((m, k), dtype=points.dtype, device=dev)
    if m == 0:
        return idx, d2
    both = torch.cat([points.float(), queries.float()])
    lo = both.min(0).values
    extent = float((both.max(0).values - lo).max()) + 1e-6
    # the first grid is as fine as f32 binning allows (a photon cloud is a
    # dense body in a halo a hundred times wider), so that a query meets
    # few more than k points in the first block that holds k
    size = max(extent * 2.0**-19, 1e-6)
    slack = extent * 2.0**-20  # how far f32 binning may move a point across a face
    offsets = torch.tensor([(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)],
                           device=dev)
    todo = torch.arange(m, device=dev)
    while todo.numel():
        g = int(extent / size) + 2
        last = g <= 3  # one block covers every point
        _, pid = _cells(points, lo, size, g)
        sorted_id, perm = torch.sort(pid)
        qc, _ = _cells(queries[todo], lo, size, g)
        nb = qc[:, None, :] + offsets[None]
        inside = ((nb >= 0) & (nb < g)).all(-1)
        nid = nb[..., 0] + g * (nb[..., 1] + g * nb[..., 2])
        first = torch.searchsorted(sorted_id, nid)
        cnt = torch.where(inside, torch.searchsorted(sorted_id, nid, right=True) - first, 0)
        total = cnt.sum(1)
        ready = (total >= k) | last
        done = torch.zeros_like(ready)
        for part in _blocks(total, ready):
            q = todo[part]
            c, f = cnt[part].reshape(-1), first[part].reshape(-1)
            seg = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
            within = torch.arange(seg.numel(), device=dev) - (torch.cumsum(c, 0) - c)[seg]
            p = perm[f[seg] + within]
            local = seg // 27
            diff = points[p] - queries[q][local]
            dist = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]
            bits = dist.float().view(torch.int32).to(torch.int64)  # d2 >= 0: bits ascend with it
            order = torch.sort((local << 32) | bits).indices
            start = torch.cumsum(total[part], 0) - total[part]
            take = order[start[:, None] + torch.arange(k, device=dev)[None]]
            kth = dist[take[:, -1]].float()
            ok = (kth <= (size - slack) ** 2) | last
            idx[q[ok]] = p[take[ok]]
            d2[q[ok]] = dist[take[ok]]
            done[part[ok]] = True
        todo = todo[~done]
        size *= 2.0
    return idx, d2


def _blocks(total, ready):
    """Index blocks of the ready queries whose pairs fit `PAIRS` a block."""
    ids = ready.nonzero()[:, 0]
    if not ids.numel():
        return []
    ends = torch.cumsum(total[ids], 0)
    cut = torch.searchsorted(ends, torch.arange(PAIRS, int(ends[-1]) + PAIRS, PAIRS,
                                                device=ends.device), right=True)
    bounds = sorted(set([0] + cut.clamp(max=ids.numel()).tolist() + [ids.numel()]))
    return [ids[a:b] for a, b in zip(bounds, bounds[1:]) if b > a]


# -- the camera pass -----------------------------------------------------------------
def _volume(sc: RefScene, spheres, o, d, hit_t, ext: float):
    """The beam-query estimate of each ray over every photon sphere,
    before the medium's colour; the pairs in the scene's type, summed in
    float64."""
    centre, radius, power = spheres
    out = torch.zeros((o.shape[0], 3), dtype=torch.float64, device=o.device)
    r2 = torch.clamp(radius * radius, min=1e-30)[None]
    scale = INV_4PI * 3.0 / math.pi
    step = max(1, SWEEP_PAIRS // max(centre.shape[0], 1))
    for a in range(0, o.shape[0], step):
        oc = [centre[None, :, i] - o[a:a + step, i:i + 1] for i in range(3)]
        oc2 = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
        dd = oc[0] * d[a:a + step, 0:1] + oc[1] * d[a:a + step, 1:2] + oc[2] * d[a:a + step, 2:3]
        dist2 = torch.clamp(oc2 - dd * dd, min=0.0)
        ok = (dd > 0.0) & (dist2 < r2) & (torch.sqrt(oc2) <= hit_t[a:a + step, None]) \
            & (radius[None] > 0.0)
        x = dist2 / r2
        w = torch.where(ok, (1.0 - x) * (1.0 - x) / r2 * torch.exp(-ext * dd) * scale, 0.0)
        out[a:a + step] = w.double() @ power.double()
    return out


def _surface(sc: RefScene, surf_rows, o, d, hit, gather: int):
    """The surface estimate at each ray's hit (zero where it missed)."""
    n = o.shape[0]
    valid = hit.valid
    pos = torch.where(valid[:, None], at(o, d, torch.where(valid, hit.t, 0.0)), 0.0)
    wo = -normalize(d)
    idx, d2 = knn(surf_rows[:, 0:3], pos, gather)
    max_d2 = d2[:, -1]
    rows = surf_rows[idx.reshape(-1)]
    p_pos, p_dir, p_pow = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]

    def rep(a):
        return a.repeat_interleave(gather, dim=0)

    mat = hit.mat
    kind, albedo = sc.mat_kind[mat], sc.mat_albedo[mat]
    shine, emit = sc.mat_shine[mat], sc.mat_emit[mat]
    normal = rep(hit.normal)
    ok = rep(valid)
    disp = rep(pos) - p_pos
    dist = torch.sqrt(dot(disp, disp))
    limit = torch.where(ok, dist * (1.0 - sc.shadow_eps), -1.0)
    ok = ok & ~occluded(sc, p_pos, disp / torch.clamp(dist, min=1e-20)[:, None], limit)
    f = bsdf(rep(kind), rep(albedo), rep(shine), normal, rep(wo), p_dir)
    contrib = f * p_pow * torch.clamp(dot(p_dir, normal), 0.0, 1.0)[:, None]
    c = torch.where(ok[:, None], contrib, 0.0).reshape(n, gather, 3).sum(1)
    color = albedo * emit[:, None] + c
    inv = torch.where(max_d2 > 0.0, 1.0 / (math.pi * max_d2), 0.0)
    return torch.where(valid[:, None], color * inv[:, None], 0.0)


def render_pixels(desc: dict, seed: int, pixels, device, dtype=torch.float32):
    """The image (mean over the render's samples, exposure applied) at
    ``pixels`` of the point-photon x beam-query render of ``desc`` seeded
    with ``seed``: (len(pixels), 3) float64."""
    settings = desc["render"]
    sc = RefScene(desc, device, dtype)
    key = rng.key(seed, device)
    clock = [time.perf_counter()]

    def lap():
        if device != "cpu":
            torch.cuda.synchronize()
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    surf_rows, vol_rows = shoot(sc, rng.fold_in(key, 1), settings["photons"],
                                settings["watts"] * settings["photons"])
    t_shoot = lap()
    _, kd2 = knn(vol_rows[:, 0:3], vol_rows[:, 0:3], RADIUS_K)
    spheres = (vol_rows[:, 0:3], torch.sqrt(kd2[:, -1]), vol_rows[:, 6:9])
    t_map = lap()
    med = sc.medium
    ext = torch.tensor(med["absorption"], dtype=torch.float32, device=device).to(dtype) \
        + torch.tensor(med["scattering"], dtype=torch.float32, device=device).to(dtype)
    pixels = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=device)
    total = torch.zeros((pixels.shape[0], 3), dtype=dtype, device=device)
    for s in range(settings["samples"]):
        o, d, _ = camera_rays(sc, pixels, torch.full_like(pixels, s), seed,
                              base=rng.fold_in(key, 2))
        hit = closest(sc, o, d, torch.full((o.shape[0],), INF, dtype=dtype, device=device))
        hit_t = torch.where(hit.valid, hit.t, INF)
        vol = _volume(sc, spheres, o, d, hit_t, float(ext)).to(dtype) * med["color"][None]
        surf = _surface(sc, surf_rows, o, d, hit, settings["gather_size"])
        t_surf = torch.exp(-ext * torch.where(hit.valid, hit.t, 0.0))
        total = total + (vol + torch.where(hit.valid[:, None], surf * t_surf[:, None], 0.0))
    t_camera = lap()
    print(f"perfbench: reference render: shoot {t_shoot:.1f} s ({surf_rows.shape[0]} surface, "
          f"{vol_rows.shape[0]} volume photons), spheres {t_map:.1f} s, camera pass "
          f"{t_camera:.1f} s", file=sys.stderr)
    return total.double().cpu().numpy() / settings["samples"] * sc.exposure
