"""Frozen copy of `rpt_tpu_torch/ops/threefry.py`'s plain threefry2x32 (the counter RNG of `jax.random`).

The plain reference draws its random numbers as the renderer documents
them: a key is two uint32 words (held in int64), ``fold_in(key, d)`` hashes
the counter pair ``(0, d)`` with the key, and ``uniforms(key, count)``
maps the XOR of the two hash words of counters ``(0, 0)``..``(0, count-1)``
to ``[0, 1)`` as ``jax.random.uniform`` does. Plain int64 torch operations,
no kernel.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s two words, (2,) int64."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """Keys (..., 2) folded with ``data`` (an int, or an integer tensor
    that broadcasts against the keys' batch), taken modulo 2^32."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = torch.tensor(int(data) & M32, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    o1, o2 = torch.broadcast_tensors(o1, o2)
    return torch.stack([o1, o2], dim=-1)


def fold_chain(keys: torch.Tensor, *tags) -> torch.Tensor:
    for tag in tags:
        keys = fold_in(keys, tag)
    return keys


def uniforms(keys: torch.Tensor, count: int = 1, lo: float = 0.0, hi: float = 1.0) -> list:
    """``count`` float32 uniforms a key in [lo, hi): counter i's two hash
    words XORed, the top 23 bits made a float in [1, 2), minus one; then
    ``lo + (hi - lo) * u`` in float32 where [lo, hi) is not [0, 1)."""
    out = []
    for c in range(count):
        cnt = torch.full(keys.shape[:-1], c, dtype=torch.int64, device=keys.device)
        o1, o2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(cnt), cnt)
        bits = (o1 ^ o2) >> 9 | 0x3F800000
        u = bits.to(torch.int32).view(torch.float32) - 1.0
        if not (lo == 0.0 and hi == 1.0):
            u = (hi - lo) * u + lo
        out.append(u)
    return out
