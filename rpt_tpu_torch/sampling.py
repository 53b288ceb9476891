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

The generator lives in `ops/threefry.py`: for CPU tensors its plain
version (int64 torch ops), for CUDA tensors K-rng (`csrc/threefry.cu`),
one launch a call of ``fold_in``/``fold``/``keys_for``/``random_bits``/
``uniform``/``uniform2``/``uniform3``.

The samplers reproduce the reference's distributions (`material.rs:173-219`,
`camera.rs:74`, `photon.rs:736-743`).
"""

from __future__ import annotations

import math

import torch

from .ops import threefry
from .ops.threefry import M32, bits_to_unit, threefry2x32  # noqa: F401  (the RNG's public names)
from .vec import Vec3, from_local

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_4PI = 1.0 / (4.0 * math.pi)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data: shape (2,) int64."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a key or a batch of keys (..., 2).
    ``data`` is an int or an integer tensor that broadcasts against the
    batch; it is taken modulo 2^32, as jax converts it to uint32."""
    return threefry.threefry_fold(keys, data)


def fold(keys: torch.Tensor, data) -> torch.Tensor:
    """Fold a static tag into a batch of keys (purpose separation)."""
    return threefry.threefry_fold(keys, data)


def keys_for(key: torch.Tensor, n: int) -> torch.Tensor:
    """Derive n per-ray keys from a base key: shape (n, 2) — the
    partitionable ``jax.random.split(key, n)``."""
    return threefry.threefry_split(key, n)


def random_bits(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit random words for counters 0..count-1 per key: (..., count)
    int64 — the partitionable ``jax.random.bits`` layout."""
    return threefry.threefry_bits(keys, count)


def uniform(keys: torch.Tensor, lo=0.0, hi=1.0) -> torch.Tensor:
    """One uniform float per key, in [lo, hi)."""
    return threefry.threefry_uniform(keys, 1, lo, hi)[0]


def uniform2(keys: torch.Tensor):
    """Two independent uniforms per key."""
    return threefry.threefry_uniform(keys, 2)


def uniform3(keys: torch.Tensor):
    return threefry.threefry_uniform(keys, 3)


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

