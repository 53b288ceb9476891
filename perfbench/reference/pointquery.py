"""The plain reference of point-photon x point-query photon mapping
(`Renderer::photon_map_render`, photon.rs:650-652) in a scene with a
homogeneous medium: the image at chosen pixels of a render of a scene
description seeded with ``seed``, in plain torch operations in float32
(TF32 off), with nothing taken from the port.

* The shoot: `photon.shoot`, unchanged (photon.rs:655-946).
* The map, the photon-map kind (photon.rs:185-305): the surface cloud
  and the volume cloud as shot; no radius pass, no thinning.
* The camera pass (photon.rs:950-985), keyed as the renderer keys it: the
  pass from ``fold_in(key, 2)``, each (pixel, sample) lane from
  ``fold_in(fold_in(that, pixel), sample)``, its estimate from fold 4 of
  that. For each lane (photon.rs:384-437):

  1. a free-flight distance d drawn from fold ``0x7`` of the lane's
     estimate key (then ``0x5D``, medium.rs:133-146), with its pdf
     sigma_t exp(-sigma_t d) and its cdf 1 - exp(-sigma_t d), sigma_t at
     the ray's origin;
  2. where d falls before the hit, or the ray hits nothing: the 50 nearest
     volume photons of the collision, each weighed by the phase (1 / 4pi)
     times the medium's colour, summed, over (4/3) pi r^3 (r the distance
     of the 50th), over sigma_t, times the transmittance to d over d's pdf;
  3. else the surface estimate at the hit (`photon._surface`: the 50
     nearest surface photons, each rechecked for occlusion, with the
     surface's own emission, over pi r^2), times the transmittance to the
     hit over 1 - cdf.

  The samples are summed in float32 in their order, then averaged.

The environment is not read. With a medium, `estimate_indirect`
(photon.rs:600-627) returns this estimate on every lane, and a ray that
hits nothing takes the volume branch; so the sky of the scene (a colour
environment) reaches no pixel, in rpt, in the port and here.

Departures from photon.rs, as the port makes them: the random numbers
are threefry2x32 streams keyed by purpose (`rng`), not rpt's generator;
float32 throughout; the k nearest are found exactly over uniform grids
(`photon.knn`), where rpt searches a kd-tree (the same photons, up to
ties at the k-th distance); the camera lanes of all samples are computed
together, in blocks of `LANES`, each branch only on the lanes that take
it.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from . import rng
from .path import INF, INV_4PI, Hits, _uniforms, at, camera_rays, closest
from .photon import _surface, knn, shoot
from .scene import RefScene

# float32 means float32: no TF32 in any product (this module has no matrix product)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LANES = 1 << 15  # camera lanes a block


def _volume(vol_rows, collision, ext, d, d_pdf, mcol, gather: int):
    """The point-query density at each collision (photon.rs:393-421)."""
    n = collision.shape[0]
    idx, d2 = knn(vol_rows[:, 0:3], collision, gather)
    max_d2 = d2[:, -1]
    p_pow = vol_rows[idx.reshape(-1), 6:9]
    ph = torch.full((n * gather, 1), INV_4PI, dtype=collision.dtype, device=collision.device)
    contrib = p_pow * mcol[None] * ph
    acc = contrib.reshape(n, gather, 3).sum(1)
    denom = (4.0 / 3.0) * math.pi * torch.clamp(max_d2, min=1e-30) ** 1.5
    out = acc / denom[:, None] / ext[:, None]
    out = out * (torch.exp(-ext * d) / torch.clamp(d_pdf, min=1e-30))[:, None]
    return torch.where((max_d2 > 0.0)[:, None], out, 0.0)


def _lanes(sc: RefScene, surf_rows, vol_rows, o, d, keys, gather: int, gather_volume: int):
    """The estimate of each camera lane (photon.rs:384-437)."""
    dt, dev = sc.dtype, sc.device
    n = o.shape[0]
    med = sc.medium
    sig_a = torch.full((n,), med["absorption"], dtype=torch.float32, device=dev).to(dt)
    sig_s = torch.full((n,), med["scattering"], dtype=torch.float32, device=dev).to(dt)
    ext = sig_a + sig_s
    hit = closest(sc, o, d, torch.full((n,), INF, dtype=dt, device=dev))
    (u,) = _uniforms(keys, (0x7, 0x5D), 1, dt)
    dist = -torch.log(torch.clamp(u, min=1e-38)) / ext
    trans = torch.exp(-ext * dist)
    d_pdf, d_cdf = ext * trans, 1.0 - trans
    in_volume = ~hit.valid | (dist < hit.t)
    out = torch.zeros((n, 3), dtype=dt, device=dev)
    v = in_volume.nonzero()[:, 0]
    if v.numel():
        collision = at(o[v], d[v], dist[v])
        out[v] = _volume(vol_rows, collision, ext[v], dist[v], d_pdf[v], med["color"],
                         gather_volume)
    s = (~in_volume).nonzero()[:, 0]  # a hit before the free flight ends
    if s.numel():
        surf = _surface(sc, surf_rows, o[s], d[s], Hits(hit.t[s], hit.normal[s], hit.mat[s]),
                        gather)
        att = torch.exp(-ext[s] * hit.t[s]) / torch.clamp(1.0 - d_cdf[s], min=1e-30)
        out[s] = surf * att[:, None]
    return out


def render_pixels(desc: dict, seed: int, pixels, device, dtype=torch.float32):
    """The image (mean over the render's samples, exposure applied) at
    ``pixels`` of the point-photon x point-query render of ``desc`` seeded
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
    pixels = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=device)
    n_pix, n_samples = pixels.shape[0], settings["samples"]
    lane_pixels = pixels.repeat(n_samples)
    lane_samples = torch.arange(n_samples, device=device).repeat_interleave(n_pix)
    values = torch.zeros((n_samples * n_pix, 3), dtype=dtype, device=device)
    for a in range(0, values.shape[0], LANES):
        b = min(a + LANES, values.shape[0])
        o, d, keys = camera_rays(sc, lane_pixels[a:b], lane_samples[a:b], seed,
                                 base=rng.fold_in(key, 2))
        values[a:b] = _lanes(sc, surf_rows, vol_rows, o, d, keys, settings["gather_size"],
                             settings["gather_size_volume"])
    total = torch.zeros((n_pix, 3), dtype=dtype, device=device)
    for s in range(n_samples):  # the renderer's float32 sum, sample by sample
        total = total + values[s * n_pix:(s + 1) * n_pix]
    t_camera = lap()
    print(f"perfbench: reference render: shoot {t_shoot:.1f} s ({surf_rows.shape[0]} surface, "
          f"{vol_rows.shape[0]} volume photons), camera pass {t_camera:.1f} s",
          file=sys.stderr)
    return total.double().cpu().numpy() / n_samples * sc.exposure
