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
``uniform``/``uniform2``/``uniform3`` on a key tensor.

The integrators carry their keys as a `KeyPath`: a key tensor (or one key
with a per-lane data word, the camera's pixel ids) and the static tags
still to be folded into it. Folding a tag into a path and indexing it
launch nothing; ``uniform*`` and `draw` on a path derive the keys and draw
in one launch (K-rng's draw form), several draws of one site together, so
a chain ``uniform(fold(fold(keys, b), 3))`` costs one launch instead of
three, and no key tensor between them is written.

The samplers reproduce the reference's distributions (`material.rs:173-219`,
`camera.rs:74`, `photon.rs:736-743`).
"""

from __future__ import annotations

import math

import torch

from .ops import threefry
from .ops.threefry import M32, Draw, bits_to_unit, threefry2x32  # noqa: F401  (public names)
from .vec import Vec3, from_local

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_4PI = 1.0 / (4.0 * math.pi)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data: shape (2,) int64."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


class KeyPath:
    """Keys with folds still to come: lane i's key is ``base``'s row i (or
    the one key (2,)), folded with ``data[i]`` where ``data`` (an integer
    tensor of the lanes) is given, then with each static tag of ``tags`` in
    turn. `fold` and indexing launch nothing; `draw` (and ``uniform*``)
    launches K-rng once; `keys` materialises the keys, in one launch where
    a fold is pending."""

    __slots__ = ("base", "data", "tags")

    def __init__(self, base: torch.Tensor, data: torch.Tensor | None = None, tags: tuple = ()):
        self.base, self.data, self.tags = base, data, tags

    def fold(self, tag: int) -> "KeyPath":
        """The path with the static ``tag`` folded in last (a full chain is
        materialised first)."""
        path = self if len(self.tags) < threefry.MAX_TAGS else KeyPath(self.keys())
        return KeyPath(path.base, path.data, path.tags + (int(tag),))

    def __getitem__(self, index) -> "KeyPath":
        """The lanes ``index`` selects (a slice, an index tensor, a mask)."""
        base = self.base if self.base.dim() == 1 else self.base[index]
        data = None if self.data is None else self.data[index]
        if base.dim() == 1 and data is None:
            raise IndexError("a KeyPath of one key has no lanes to index")
        return KeyPath(base, data, self.tags)

    def keys(self) -> torch.Tensor:
        """The keys as a tensor (..., 2); the base itself where no fold is
        pending."""
        if self.data is None and not self.tags:
            return self.base
        return threefry.threefry_draw(self.base, self.data, self.tags, (), key_out=True)[1]


def key_path(keys, data: torch.Tensor | None = None) -> KeyPath:
    """``keys`` (a key tensor (..., 2), or a `KeyPath`, returned as it is)
    as a `KeyPath`; with ``data``, the per-lane word folded in first
    (``fold_in(keys, data)``)."""
    if isinstance(keys, KeyPath):
        if data is not None:
            raise ValueError("key_path: a KeyPath takes no data")
        return keys
    return KeyPath(keys, data)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a key or a batch of keys (..., 2).
    ``data`` is an int or an integer tensor that broadcasts against the
    batch; it is taken modulo 2^32, as jax converts it to uint32."""
    return threefry.threefry_fold(keys, data)


def fold(keys, data):
    """Fold a static tag into a batch of keys (purpose separation): one
    launch on a key tensor, none on a `KeyPath` (the fold is pending)."""
    if isinstance(keys, KeyPath):
        return keys.fold(data)
    return threefry.threefry_fold(keys, data)


def draw(keys, *draws: Draw) -> tuple:
    """Every `Draw` of ``draws`` (suffix tags, count, lo, hi) from the keys
    of ``keys`` (a `KeyPath` or a key tensor) in one launch: the floats in
    order, ``count`` tensors a draw."""
    path = key_path(keys)
    return threefry.threefry_draw(path.base, path.data, path.tags, draws)[0]


def keys_for(key: torch.Tensor, n: int) -> torch.Tensor:
    """Derive n per-ray keys from a base key: shape (n, 2) — the
    partitionable ``jax.random.split(key, n)``."""
    return threefry.threefry_split(key, n)


def random_bits(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit random words for counters 0..count-1 per key: (..., count)
    int64 — the partitionable ``jax.random.bits`` layout."""
    return threefry.threefry_bits(keys, count)


def uniform(keys, lo=0.0, hi=1.0) -> torch.Tensor:
    """One uniform float per key, in [lo, hi)."""
    if isinstance(keys, KeyPath):
        return draw(keys, Draw((), 1, lo, hi))[0]
    return threefry.threefry_uniform(keys, 1, lo, hi)[0]


def uniform2(keys):
    """Two independent uniforms per key."""
    if isinstance(keys, KeyPath):
        return draw(keys, Draw((), 2))
    return threefry.threefry_uniform(keys, 2)


def uniform3(keys):
    if isinstance(keys, KeyPath):
        return draw(keys, Draw((), 3))
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

