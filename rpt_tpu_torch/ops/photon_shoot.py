"""The interaction of one level of the photon shoot (K-shoot).

The JAX package shoots photons level by level (`rpt_tpu/integrators/
photon.py:137-294`): each bounce level is a closest-hit query, then the
level's interaction (the free flight through the medium, the phase or the
material's lobe, the roulettes, the deposits and the survivors), all one
XLA program. The port's plain version of the interaction is
`shoot_level_plain`: the chain of torch ops of a level after its closest
hit, about 490 launches on the card and three host syncs (the two deposit
gathers and the survivors' ``nonzero``). The kernel is
`csrc/photon_shoot.cu`: one call a level (three kernels: the interaction,
one thread a lane; a scan of the blocks' counts; the scatter of deposit
rows and survivors in lane order), after which the host reads one number,
the survivors.

`ShootChunk` holds a chunk's state on the card: its lanes' rays, powers
and key rows (two sets, the level's and the next), and the deposit
buffers at the chain's capacities, filled at a running offset on the card.
`shoot_level` runs one level on it and counts its calls in
``shoot_level.launches``. Both serve CUDA tensors only, with no medium or
a preset's (`medium.MediumPreset`), and raise on anything else.
`_shoot_launch` (`integrators/photon.py`) takes them for every chunk on
the card and the plain version for every chunk on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .. import sampling
from ..dtypes import DTYPE, INF
from ..materials import bsdf, sample_f
from ..medium import GLOW_SPLIT_Y, HENYEY_GREENSTEIN
from ..ray import Hit, Ray
from ..vec import Vec3, where

ROW = 12  # a deposit: [pos(3), wo(3), power(3), ray origin(3)] (integrators/photon.py PHOTON_ROW)


# ---------------------------------------------------------------------------
# The plain version: the chain of torch ops of a level


def shoot_level_plain(ray: Ray, power: Vec3, keys, hit: Hit, b: int, medium, materials):
    """The interaction of shoot level ``b`` over its lanes (``ray``,
    ``power``, ``keys`` a `sampling.KeyPath`) given their closest ``hit``:
    returns the level's surface rows and volume rows (lane order) and the
    survivors' ray, power and keys, compacted in lane order."""
    nw = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    zero = Vec3.zeros(nw, dev)
    kb = sampling.fold(keys, b)
    wo = -ray.dir.normalize()

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

    # ---- next level: survivors compacted in lane order -------------
    cont = vol_continue | surf_continue
    new_power = where(vol_event, vol_power_next, surf_power_next)
    new_ray = Ray(dpos, where(vol_event, wi_v, wi_s))
    sel = torch.nonzero(cont).squeeze(1)
    return (rows[surf_deposit], rows[vol_event], Ray(new_ray.origin[sel], new_ray.dir[sel]),
            new_power.broadcast_to((nw,))[sel], keys[sel])


# ---------------------------------------------------------------------------
# The kernel


class _ShootParams(ctypes.Structure):
    """`csrc/photon_shoot.cu` ShootParams, passed by value to the kernels."""

    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _fields_ = [("ray", _P), ("power", _P), ("keys", _P), ("ray_out", _P), ("power_out", _P),
                ("keys_out", _P), ("hit_t", _P), ("hit_normal", _P * 3), ("hit_material", _P),
                ("hit_stride", ctypes.c_int64 * 5), ("tmp", _P), ("flags", _P),
                ("block_counts", _P), ("offsets", _P), ("surface", _P), ("volume", _P),
                ("mat_kind", _P), ("mat_albedo", _P * 3), ("mat_shininess", _P), ("mat_ior", _P),
                ("stride", ctypes.c_int64), ("n", _I), ("level", _I), ("s_cap", _I),
                ("v_cap", _I), ("n_materials", _I), ("medium", _I), ("ext", _F), ("rr", _F),
                ("phase", _F), ("pdf", _F), ("color", _F * 3), ("color_below", _F * 3),
                ("split_y", _F), ("hg_invert", _I), ("hg_two_g", _F), ("hg_one_plus_g", _F),
                ("hg_one_minus_g2", _F), ("hg_one_plus_g2", _F), ("hg_inv_two_g", _F),
                ("hg_norm", _F)]


THREADS = 256  # csrc/photon_shoot.cu kThreads: a block's lanes


def _medium_constants(p: _ShootParams, medium) -> None:
    """The medium's constants as float32, rounded as the chain's torch ops
    round them: a Python number in an op is its float32; `extinction` is
    the float32 sum of the coefficients and the roulette their float32
    quotient; `tensor / number` multiplies by the float32 reciprocal."""
    if medium is None:
        return
    pre = medium.preset
    f32 = np.float32
    ext = f32(pre.absorption) + f32(pre.scattering)
    p.medium, p.ext, p.rr = pre.kind, ext, f32(pre.scattering) / ext
    p.phase = p.pdf = medium.phase_const or 0.0  # None for Henyey-Greenstein
    p.color[:], p.color_below[:], p.split_y = pre.color, pre.color_below, GLOW_SPLIT_Y
    if pre.kind == HENYEY_GREENSTEIN:
        g = pre.g
        p.pdf = sampling.INV_4PI
        p.hg_invert = not abs(g) < 1e-6
        p.hg_two_g, p.hg_one_plus_g = 2.0 * g, 1.0 + g
        p.hg_one_minus_g2, p.hg_one_plus_g2 = 1.0 - g * g, 1.0 + g * g
        p.hg_inv_two_g = f32(1.0) / f32(2.0 * g) if p.hg_invert else 0.0
        p.hg_norm = sampling.INV_4PI * (1.0 - g * g)


def _table_columns(materials) -> list:
    """The material table's kind, albedo x, y, z, shininess and ior as
    contiguous (M,) columns (copies where a column is a strided view)."""
    albedo = materials.albedo
    cols = (("kind", materials.kind, torch.int32), ("albedo.x", albedo.x, DTYPE),
            ("albedo.y", albedo.y, DTYPE), ("albedo.z", albedo.z, DTYPE),
            ("shininess", materials.shininess, DTYPE), ("ior", materials.ior, DTYPE))
    m = materials.kind.shape[0] if materials.kind.dim() == 1 else 0
    for name, col, dtype in cols:
        if col.dtype != dtype or col.shape != (m,) or m == 0:
            raise ValueError(f"ShootChunk: the material table's {name} must be {dtype} (M,) "
                             f"with M > 0, got {col.dtype} {tuple(col.shape)}")
        if col.device != materials.kind.device:
            raise ValueError(f"ShootChunk: the material table's {name} is on {col.device}")
    return [col.contiguous() for _, col, _ in cols]


class ShootChunk:
    """K-shoot's state for one chunk of photons on the card: the lanes'
    rays (6, n), powers (3, n) and key rows (n, 2), twice (the level's and
    the survivors'); the deposit buffers, ``s_cap`` and ``v_cap`` rows of
    `ROW` floats; ``offsets``, a row a level of (surface rows, volume rows,
    survivors, unused) that the card fills. ``lanes`` is the host's count
    of the live lanes, ``level`` the levels run.

    ``ray``, ``power`` (float32, broadcast to the lanes) and ``keys`` (the
    int64 key rows, ``(n, 2)``) are the chunk's photons at level 0; the
    material table and the medium (None or a preset's) are the scene's."""

    def __init__(self, ray: Ray, power: Vec3, keys: torch.Tensor, materials, medium,
                 max_depth: int, s_cap: int, v_cap: int):
        dev = keys.device
        if medium is not None and medium.preset is None:
            raise ValueError("ShootChunk: a medium of the caller's own callables has no preset "
                             "for K-shoot; its lanes take shoot_level_plain")
        if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
            raise ValueError(f"ShootChunk: keys must be int64 (n, 2), got {keys.dtype} "
                             f"{tuple(keys.shape)}")
        n = keys.shape[0]
        comps = (ray.origin.x, ray.origin.y, ray.origin.z, ray.dir.x, ray.dir.y, ray.dir.z,
                 power.x, power.y, power.z)
        for c in comps:
            if not isinstance(c, torch.Tensor) or c.dtype != DTYPE or c.device != dev:
                raise ValueError("ShootChunk: the rays and powers must be float32 tensors on "
                                 f"{dev}")
        table = _table_columns(materials)
        if materials.kind.device != dev:
            raise ValueError(f"ShootChunk: the material table is on {materials.kind.device}, "
                             f"the lanes on {dev}")
        if min(max_depth, s_cap, v_cap) < 0 or max(n * (max_depth + 1), s_cap, v_cap) >= 1 << 31:
            raise ValueError("ShootChunk: the lanes, levels and capacities must be counted in "
                             f"int32, got {n} lanes, {max_depth} levels, capacities {s_cap}, "
                             f"{v_cap}")
        if dev.type != "cuda":
            raise ValueError(f"ShootChunk: unsupported device {dev}; CPU lanes take "
                             "shoot_level_plain")
        f = dict(dtype=DTYPE, device=dev)
        self.max_depth, self.s_cap, self.v_cap = max_depth, s_cap, v_cap
        self._rays = [torch.empty((6, n), **f) for _ in range(2)]
        self._powers = [torch.empty((3, n), **f) for _ in range(2)]
        self._keys = [keys.contiguous().clone(), torch.empty_like(keys)]
        for k, c in enumerate(comps):
            (self._rays[0][k] if k < 6 else self._powers[0][k - 6]).copy_(c.expand(n))
        self.tmp = torch.empty((9, n), **f)
        self.flags = torch.empty(n, dtype=torch.uint8, device=dev)
        self.block_counts = torch.empty((max(1, -(-n // THREADS)), 3), dtype=torch.int32,
                                        device=dev)
        self.offsets = torch.zeros((max_depth + 1, 4), dtype=torch.int32, device=dev)
        self.surface = torch.empty((s_cap, ROW), **f)
        self.volume = torch.empty((v_cap, ROW), **f)
        self.lanes, self.level = n, 0

        p = _ShootParams()
        p.tmp, p.flags, p.block_counts = (self.tmp.data_ptr(), self.flags.data_ptr(),
                                          self.block_counts.data_ptr())
        p.offsets, p.surface, p.volume = (self.offsets.data_ptr(), self.surface.data_ptr(),
                                          self.volume.data_ptr())
        self._table = table  # kept alive with the pointers to it
        p.mat_kind, p.mat_shininess, p.mat_ior = (table[0].data_ptr(), table[4].data_ptr(),
                                                  table[5].data_ptr())
        for k in range(3):
            p.mat_albedo[k] = table[1 + k].data_ptr()
        p.stride, p.s_cap, p.v_cap = n, s_cap, v_cap
        p.n_materials = materials.kind.shape[0]
        _medium_constants(p, medium)
        self._params = p

    def ray(self) -> Ray:
        """The live lanes' rays: views of the level's state."""
        r = self._rays[self.level % 2][:, :self.lanes]
        return Ray(Vec3(r[0], r[1], r[2]), Vec3(r[3], r[4], r[5]))

    def power(self) -> Vec3:
        """The live lanes' powers: views of the level's state."""
        p = self._powers[self.level % 2][:, :self.lanes]
        return Vec3(p[0], p[1], p[2])

    def keys(self) -> torch.Tensor:
        """The live lanes' key rows: a view of the level's state."""
        return self._keys[self.level % 2][:self.lanes]

    def rows(self) -> tuple:
        """After the last level: (surface rows, volume rows, dropped), the
        rows below the capacities as their own tensors and the count of
        those past them, as the chain's ``rows[:cap]``. Reads the running
        totals once."""
        s_n, v_n = self.offsets[self.level, :2].tolist()
        dropped = max(0, s_n - self.s_cap) + max(0, v_n - self.v_cap)
        return (self.surface[:min(s_n, self.s_cap)].clone(),
                self.volume[:min(v_n, self.v_cap)].clone(), dropped)


def _hit_lanes(hit: Hit, n: int, dev) -> list:
    cols = [(hit.time, DTYPE), (hit.normal.x, DTYPE), (hit.normal.y, DTYPE),
            (hit.normal.z, DTYPE), (hit.material, torch.int32)]
    for x, dtype in cols:
        if not isinstance(x, torch.Tensor) or x.dtype != dtype or x.device != dev or \
                x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"shoot_level: the hit must be {n} lanes of float32 (int32 "
                             f"material) on {dev}")
    return [x for x, _ in cols]


def _launch(chunk: ShootChunk, hit: Hit, level: int) -> None:
    """Enqueue one call of K-shoot for ``level`` on the chunk's live lanes
    and count it; nothing is read back and the chunk's level is not
    advanced, so a call with the same chunk state, hit and level writes the
    same outputs again (what a timing of repeated calls needs; the path
    calls `shoot_level`)."""
    n, dev = chunk.lanes, chunk.offsets.device
    cols = _hit_lanes(hit, n, dev)
    p, cur, nxt = chunk._params, level % 2, (level + 1) % 2
    p.ray, p.power, p.keys = (chunk._rays[cur].data_ptr(), chunk._powers[cur].data_ptr(),
                              chunk._keys[cur].data_ptr())
    p.ray_out, p.power_out, p.keys_out = (chunk._rays[nxt].data_ptr(),
                                          chunk._powers[nxt].data_ptr(),
                                          chunk._keys[nxt].data_ptr())
    p.hit_t, p.hit_material = cols[0].data_ptr(), cols[4].data_ptr()
    for k in range(3):
        p.hit_normal[k] = cols[1 + k].data_ptr()
    p.hit_stride[:] = [x.stride(0) for x in cols]
    p.n, p.level = n, level
    code = _build.library().lib.rpt_photon_shoot_level(ctypes.byref(p),
                                                         _build.stream_of(chunk.offsets))
    shoot_level.launches += 1
    _build.check(code, "shoot_level")


def shoot_level(chunk: ShootChunk, hit: Hit, level: int) -> int:
    """Run shoot level ``level`` (the chunk's next) on the chunk's live
    lanes given their closest ``hit``: one call of K-shoot, which appends
    the level's deposits and writes the survivors' state; then reads the
    survivors, the one value the host takes a level. Returns them."""
    if level != chunk.level or level >= chunk.max_depth:
        raise ValueError(f"shoot_level: level {level} is not the chunk's next ({chunk.level} of "
                         f"{chunk.max_depth})")
    _launch(chunk, hit, level)
    chunk.lanes = int(chunk.offsets[level + 1, 2])
    chunk.level = level + 1
    return chunk.lanes


shoot_level.launches = 0
