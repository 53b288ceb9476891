"""Counter-based RNG and sampling routines — port of `rpt_tpu/sampling.py`.

The JAX package draws every random number from threefry2x32 counter keys
(`rpt_tpu/sampling.py:29-53`): every lane carries a key, and bounces and
purposes derive subkeys by ``fold_in``. This module re-implements that
generator bit for bit in torch, so both packages trace the same rays:

* a key is an int64 tensor of shape ``(..., 2)`` holding the two uint32
  words of a ``jax.random.key`` (torch's uint32 arithmetic is thin, so the
  words live in int64 and every add/shift is masked back to 32 bits);
* ``key(seed)`` is ``jax.random.key(seed)``'s key data ``[seed >> 32,
  seed & 0xFFFFFFFF]``;
* ``fold_in(k, d)`` hashes the counter pair ``(0, d)`` with ``k``;
* ``keys_for(k, n)`` is the partitionable ``jax.random.split``: key ``i``
  is the hash of the counter pair ``(0, i)`` (``jax_threefry_partitionable``
  is True under jax 0.9);
* ``uniform`` draws 32 random bits as the XOR of the two hash words of
  counter ``(0, i)`` and maps ``bits >> 9 | 0x3F800000`` to ``[1, 2) - 1``.

The samplers reproduce the reference's distributions (`material.rs:173-219`,
`camera.rs:74`, `photon.rs:736-743`).
"""

from __future__ import annotations

import math

import torch

from .vec import Vec3, from_local

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_4PI = 1.0 / (4.0 * math.pi)

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds, as `jax._src.prng._threefry2x32_lowering`.
    All arguments are int64 tensors (or ints) holding uint32 values; they
    broadcast. Returns the two uint32 output words as int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data: shape (2,) int64."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a key or a batch of keys (..., 2).
    ``data`` is an int or an integer tensor that broadcasts against the
    batch; it is taken modulo 2^32, as jax converts it to uint32."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    if not isinstance(o1, torch.Tensor) or o1.shape != o2.shape:
        o1, o2 = torch.broadcast_tensors(torch.as_tensor(o1), torch.as_tensor(o2))
    return torch.stack([o1, o2], dim=-1)


def fold(keys: torch.Tensor, data) -> torch.Tensor:
    """Fold a static tag into a batch of keys (purpose separation)."""
    return fold_in(keys, data)


def keys_for(key: torch.Tensor, n: int) -> torch.Tensor:
    """Derive n per-ray keys from a base key: shape (n, 2) — the
    partitionable ``jax.random.split(key, n)``."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[0], key[1], 0, counts)
    o1, o2 = torch.broadcast_tensors(o1, o2)
    return torch.stack([o1, o2], dim=-1)


def random_bits(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit random words for counters 0..count-1 per key: (..., count)
    int64 — the partitionable ``jax.random.bits`` layout."""
    c = torch.arange(count, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], 0, c)
    return o1 ^ o2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) exactly as ``jax.random.uniform``."""
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, lo=0.0, hi=1.0) -> torch.Tensor:
    """One uniform float per key, in [lo, hi)."""
    u = bits_to_unit(random_bits(keys, 1)[..., 0])
    if lo == 0.0 and hi == 1.0:
        return u
    return lo + (hi - lo) * u


def uniform2(keys: torch.Tensor):
    """Two independent uniforms per key."""
    u = bits_to_unit(random_bits(keys, 2))
    return u[..., 0], u[..., 1]


def uniform3(keys: torch.Tensor):
    u = bits_to_unit(random_bits(keys, 3))
    return u[..., 0], u[..., 1], u[..., 2]


def unit_disc(r1, r2):
    """Uniform point on the unit disc (rand_distr::UnitDisc, `camera.rs:74`)."""
    r = torch.sqrt(r1)
    phi = TWO_PI * r2
    return r * torch.cos(phi), r * torch.sin(phi)


def unit_circle(r1):
    """Uniform point on the unit circle (`monomial_surface.rs:110`)."""
    phi = TWO_PI * r1
    return torch.cos(phi), torch.sin(phi)


def cosine_hemisphere(r1, r2, n: Vec3):
    """Cosine-weighted hemisphere around ``n``; returns (dir, pdf)
    (`material.rs:173-197`)."""
    phi = TWO_PI * r1
    cos_t = torch.sqrt(r2)
    sin_t = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    local = Vec3(sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
    return from_local(local, n).normalize(), cos_t * INV_PI


def phong_lobe(r1, r2, shininess, axis: Vec3):
    """cos^n lobe around ``axis``; returns (dir, pdf) (`material.rs:199-219`)."""
    phi = TWO_PI * r1
    cos_t = r2 ** (1.0 / (shininess + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = Vec3(sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
    pdf = (shininess + 1.0) / TWO_PI * cos_t**shininess
    return from_local(local, axis).normalize(), pdf


def uniform_hemisphere(r1, r2, n: Vec3):
    """Uniform hemisphere around ``n``; pdf = 1/(2 pi) (`photon.rs:736-743`)."""
    phi = TWO_PI * r1
    cos_t = 1.0 - r2
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = Vec3(sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
    return from_local(local, n).normalize(), torch.full_like(r1, 0.5 * INV_PI)


def uniform_sphere(r1, r2) -> Vec3:
    """Exact uniform direction on the unit sphere (the JAX package's
    deliberate replacement of the reference's cube sampler, PARITY.md)."""
    z = 1.0 - 2.0 * r1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * r2
    return Vec3(r * torch.cos(phi), z, r * torch.sin(phi))

