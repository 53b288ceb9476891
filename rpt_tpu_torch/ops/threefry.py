"""The threefry2x32 counter RNG: its plain version and K-rng.

The JAX package draws every random number through `jax.random`
(`rpt_tpu/sampling.py:29-53`), whose threefry2x32 is one fused XLA
program a call on the TPU. The plain version here re-implements it bit
for bit in int64 torch ops (a key is an int64 tensor ``(..., 2)`` holding
the two uint32 words of a ``jax.random.key``; every add and shift is
masked back to 32 bits), about 180 torch launches a call on the card.
K-rng (`csrc/threefry.cu`) computes the same words in one launch a call.

The wrappers `threefry_fold` (``fold_in``), `threefry_split` (the
partitionable ``jax.random.split``), `threefry_uniform` (``uniform`` with
1-3 draws a key, mapped to ``[lo, hi)``), `threefry_bits`
(``random_bits``) and `threefry_draw` (derive and draw: a key's chain of
folds and up to eight draws from it, ``uniform(fold(...fold(fold_in(key,
data), t0)..., tN))`` of several call sites in one launch) run the plain
version for tensors on the CPU and launch K-rng for CUDA tensors, or
raise. Each counts its launches (``threefry_fold.launches`` ...).
`_prepare_fold`, `_prepare_words` and `_prepare_draw` turn a call into the
kernel's flat arguments; `fold_flat_plain`, `words_flat_plain` and
`draw_flat_plain` are the kernel's per-lane arithmetic on those arguments
in torch ops, so the CPU tests hold the flattening to `jax.random` too.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _build

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
MAX_LANES = (1 << 31) - 1  # the kernels index lanes with int
# the draw form's limits (`csrc/threefry.cu` kMaxTags, kMaxDraws, kMaxSuffix)
MAX_TAGS = 8
MAX_DRAWS = 8
MAX_SUFFIX = 2


class Draw(NamedTuple):
    """One draw of `threefry_draw`: ``count`` uniforms in [lo, hi), as
    ``uniform`` draws them, from the chain's key folded with the static
    ``tags`` (at most `MAX_SUFFIX`)."""

    tags: tuple = ()
    count: int = 1
    lo: float = 0.0
    hi: float = 1.0


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


def fold_in_plain(keys: torch.Tensor, data) -> torch.Tensor:
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


def keys_for_plain(key: torch.Tensor, n: int) -> torch.Tensor:
    """n per-ray keys from a base key, (n, 2): the partitionable
    ``jax.random.split(key, n)``."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[0], key[1], 0, counts)
    o1, o2 = torch.broadcast_tensors(o1, o2)
    return torch.stack([o1, o2], dim=-1)


def random_bits_plain(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit random words for counters 0..count-1 per key: (..., count)
    int64 — the partitionable ``jax.random.bits`` layout."""
    c = torch.arange(count, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], 0, c)
    return o1 ^ o2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) exactly as ``jax.random.uniform``."""
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniforms_plain(keys: torch.Tensor, count: int, lo=0.0, hi=1.0) -> tuple:
    """``count`` independent uniforms per key in [lo, hi): a tuple of
    ``count`` float32 tensors of the keys' batch shape."""
    u = bits_to_unit(random_bits_plain(keys, count))
    if not (lo == 0.0 and hi == 1.0):
        u = lo + (hi - lo) * u
    return tuple(u[..., c] for c in range(count))


def draw_plain(keys: torch.Tensor, data, tags, draws, key_out: bool = False) -> tuple:
    """`threefry_draw` composed of the unfused calls: ``fold_in_plain`` of
    ``data`` (where not None) and of each tag in turn, then for each draw
    its suffix folds and ``uniforms_plain``. Returns (the draws' floats in
    order, one tensor a word; the chain's key where ``key_out``, else
    None)."""
    if data is not None:
        keys = fold_in_plain(keys, data)
    for tag in tags:
        keys = fold_in_plain(keys, tag)
    floats = []
    for d in draws:
        k = keys
        for tag in d.tags:
            k = fold_in_plain(k, tag)
        floats += uniforms_plain(k, d.count, d.lo, d.hi)
    return tuple(floats), (keys if key_out else None)


@dataclass
class Flat:
    """A call as the kernel takes it: ``n`` lanes; lane i hashes key row
    ``i * key_stride`` of ``keys`` ((rows, 2) int64, contiguous) and, for a
    fold, the counter ``(0, data[i * data_stride] mod 2^32)``, or ``(0,
    data_scalar)`` where ``data`` is None; for uniform/bits, ``count``
    counters a key and the map ``lo + scale * u`` (float32 values).
    ``shape`` is the output's batch shape. A split (``lane_data``) hashes
    the counter ``(0, i)``."""

    keys: torch.Tensor
    key_stride: int
    n: int
    shape: tuple
    lane_data: bool = False
    data: torch.Tensor | None = None
    data_stride: int = 0
    data_scalar: int = 0
    count: int = 1
    lo: float = 0.0
    scale: float = 1.0
    tags: tuple = ()
    draws: tuple = ()  # (suffix tags, count, lo, scale) a draw, float32 values
    key_out: bool = False
    template: object = None  # the draw's `_DrawParams` with its tags and draws


def _check_keys(name: str, keys) -> None:
    if not isinstance(keys, torch.Tensor) or keys.dtype != torch.int64:
        raise ValueError(f"{name}: keys must be an int64 tensor, got "
                         f"{getattr(keys, 'dtype', type(keys).__name__)}")
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"{name}: keys must have shape (..., 2), got {tuple(keys.shape)}")


def _check_count(name: str, count) -> None:
    if isinstance(count, bool) or not isinstance(count, numbers.Integral) or count < 1:
        raise ValueError(f"{name}: count must be a positive int, got {count!r}")


def _lanes(name: str, shape) -> int:
    n = math.prod(shape)
    if n > MAX_LANES:
        raise ValueError(f"{name}: {n} lanes; the kernel takes at most {MAX_LANES}")
    return n


def _broadcast(keys: torch.Tensor, data: torch.Tensor) -> tuple:
    """The batch shape of ``keys`` (..., 2) broadcast against ``data``'s;
    the common forms (one key, or equal shapes) without
    `torch.broadcast_shapes`, whose Python reference implementation costs
    more host time than the rest of a call's flattening."""
    batch, other = tuple(keys.shape[:-1]), tuple(data.shape)
    if not batch or batch == other:
        return other
    return tuple(torch.broadcast_shapes(batch, other))


def _rows(t: torch.Tensor, shape, width: int | None):
    """``t`` (batch dims, then ``width`` if given) as contiguous rows over
    the broadcast batch ``shape``, and the row stride: 0 for one row for
    every lane, else 1 (broadcasting that would repeat rows copies)."""
    if (t.dim() == (2 if width else 1) and t.shape[0] > 1 and t.shape[0] == math.prod(shape)
            and t.is_contiguous()):
        return t, 1  # already flat rows
    batch = t.shape[:-1] if width else t.shape
    tail = (width,) if width else ()
    if math.prod(batch) == 1:
        return t.reshape(1, *tail).contiguous(), 0
    if math.prod(batch) != math.prod(shape):
        t = t.expand(*shape, *tail)
    return t.reshape(-1, *tail).contiguous(), 1


def _prepare_fold(keys: torch.Tensor, data) -> Flat:
    """`threefry_fold`'s flat arguments: the key batch broadcast against
    the data batch. The kernel reads the low 32 bits of each int64 data
    word, which is ``data & M32``."""
    _check_keys("threefry_fold", keys)
    if isinstance(data, torch.Tensor) and data.dim() == 0 and data.device.type == "cpu":
        data = int(data)
    if isinstance(data, torch.Tensor):
        if data.dtype in (torch.bool,) or data.is_floating_point() or data.is_complex():
            raise ValueError(f"threefry_fold: data must be an integer tensor, got {data.dtype}")
        if data.device != keys.device:
            raise ValueError(f"threefry_fold: data is on {data.device}, the keys on "
                             f"{keys.device}")
        shape = _broadcast(keys, data)
        n = _lanes("threefry_fold", shape)
        flat_keys, key_stride = _rows(keys, shape, 2)
        flat_data, data_stride = _rows(data.to(torch.int64), shape, None)
        return Flat(flat_keys, key_stride, n, shape, data=flat_data, data_stride=data_stride)
    if isinstance(data, bool) or not isinstance(data, numbers.Integral):
        raise ValueError(f"threefry_fold: data must be an int or an integer tensor, got "
                         f"{type(data).__name__}")
    shape = tuple(keys.shape[:-1])
    flat_keys, key_stride = _rows(keys, shape, 2)
    return Flat(flat_keys, key_stride, _lanes("threefry_fold", shape), shape,
                data_scalar=int(data) & M32)


def _prepare_split(key: torch.Tensor, n) -> Flat:
    """`threefry_split`'s arguments: one key (2,) for ``n`` lanes, lane i
    hashing the counter ``(0, i)``."""
    _check_keys("threefry_split", key)
    if key.shape != (2,):
        raise ValueError(f"threefry_split: the key must have shape (2,), got {tuple(key.shape)}")
    if isinstance(n, bool) or not isinstance(n, numbers.Integral) or n < 0:
        raise ValueError(f"threefry_split: n must be an int >= 0, got {n!r}")
    return Flat(key.reshape(1, 2).contiguous(), 0, _lanes("threefry_split", (int(n),)), (int(n),),
                lane_data=True)


def _prepare_words(name: str, keys: torch.Tensor, count, lo=0.0, hi=1.0) -> Flat:
    """`threefry_uniform`'s and `threefry_bits`' flat arguments: one key a
    lane, ``count`` counters a key; ``lo`` and ``hi - lo`` rounded to
    float32 as torch rounds a Python scalar against a float32 tensor."""
    _check_keys(name, keys)
    _check_count(name, count)
    for arg, v in (("lo", lo), ("hi", hi)):
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise ValueError(f"{name}: {arg} must be a real number, got {type(v).__name__}")
    shape = tuple(keys.shape[:-1])
    return Flat(keys.reshape(-1, 2).contiguous(), 1, _lanes(name, shape), shape,
                count=int(count), lo=float(np.float32(lo)), scale=float(np.float32(hi - lo)))


def _check_tags(name: str, what: str, tags, most: int) -> tuple:
    if len(tags) > most or any(isinstance(t, bool) or not isinstance(t, numbers.Integral)
                               for t in tags):
        raise ValueError(f"{name}: {what} must be at most {most} ints, got {tags!r}")
    return tuple(int(t) & M32 for t in tags)


@functools.lru_cache(maxsize=512)
def _draw_statics(tags: tuple, draws: tuple, key_out: bool) -> tuple:
    """What a draw's call site fixes, checked and converted once: (the
    chain's tags mod 2^32; each draw's (suffix mod 2^32, count, float32
    lo, float32 hi - lo); a `_DrawParams` holding both, the template of
    the call's parameter struct)."""
    name = "threefry_draw"
    tags = _check_tags(name, "the chain", tags, MAX_TAGS)
    if len(draws) > MAX_DRAWS or not (draws or key_out):
        raise ValueError(f"{name}: 1-{MAX_DRAWS} draws (or none and the key), got {len(draws)}")
    specs = []
    for d in draws:
        if not isinstance(d, Draw):
            raise ValueError(f"{name}: a draw must be a Draw, got {type(d).__name__}")
        _check_count(name, d.count)
        for arg, v in (("lo", d.lo), ("hi", d.hi)):
            if isinstance(v, bool) or not isinstance(v, numbers.Real):
                raise ValueError(f"{name}: {arg} must be a real number, got {type(v).__name__}")
        specs.append((_check_tags(name, "a draw's suffix", tuple(d.tags), MAX_SUFFIX),
                      int(d.count), float(np.float32(d.lo)), float(np.float32(d.hi - d.lo))))
    template = _DrawParams(n_tags=len(tags), n_draws=len(specs))
    template.tags[:len(tags)] = tags
    for spec, (suffix, count, lo, scale) in zip(template.draws, specs):
        spec.tags[:len(suffix)] = suffix
        spec.n_tags, spec.count, spec.lo, spec.scale = len(suffix), count, lo, scale
    return tags, tuple(specs), template


def _prepare_draw(keys: torch.Tensor, data, tags, draws, key_out: bool) -> Flat:
    """`threefry_draw`'s flat arguments: the key batch broadcast against
    the data batch as `_prepare_fold` does (strides 0/1), the chain's tags
    mod 2^32, and each draw's suffix, count and ``lo``, ``hi - lo`` rounded
    to float32 as `_prepare_words` rounds them (`_draw_statics`, once a
    call site)."""
    name = "threefry_draw"
    _check_keys(name, keys)
    try:
        tags, specs, template = _draw_statics(tuple(tags), tuple(draws), bool(key_out))
    except TypeError as e:  # an unhashable tag or draw
        raise ValueError(f"{name}: tags and draws must hold numbers: {e}") from None
    if data is None:
        shape = tuple(keys.shape[:-1])
        flat_keys, key_stride = _rows(keys, shape, 2)
        flat = Flat(flat_keys, key_stride, _lanes(name, shape), shape)
    else:
        if not isinstance(data, torch.Tensor) or data.dtype == torch.bool or (
                data.is_floating_point() or data.is_complex()):
            raise ValueError(f"{name}: data must be an integer tensor or None, got "
                             f"{getattr(data, 'dtype', type(data).__name__)}")
        if data.device != keys.device:
            raise ValueError(f"{name}: data is on {data.device}, the keys on {keys.device}")
        shape = _broadcast(keys, data)
        flat_keys, key_stride = _rows(keys, shape, 2)
        flat_data, data_stride = _rows(data if data.dtype == torch.int64 else
                                       data.to(torch.int64), shape, None)
        flat = Flat(flat_keys, key_stride, _lanes(name, shape), shape, data=flat_data,
                    data_stride=data_stride)
    flat.tags, flat.draws, flat.key_out, flat.template = tags, specs, bool(key_out), template
    return flat


def fold_flat_plain(flat: Flat) -> torch.Tensor:
    """K-rng's fold (and split) lane by lane in torch ops on ``flat``:
    (n, 2) int64. A split's lanes hash their own index."""
    lane = torch.arange(flat.n, dtype=torch.int64, device=flat.keys.device)
    k = flat.keys[lane * flat.key_stride]
    if flat.lane_data:
        d = lane
    elif flat.data is not None:
        d = flat.data[lane * flat.data_stride] & M32
    else:
        d = flat.data_scalar
    o1, o2 = threefry2x32(k[..., 0], k[..., 1], 0, d)
    o1, o2 = torch.broadcast_tensors(torch.as_tensor(o1), torch.as_tensor(o2))
    return torch.stack([o1, o2], dim=-1).reshape(flat.n, 2)


def words_flat_plain(flat: Flat, as_bits: bool) -> torch.Tensor:
    """K-rng's uniform (planar (count, n) float32: ``lo + scale * u``, two
    float32 roundings) or bits ((n, count) int64) in torch ops on ``flat``."""
    c = torch.arange(flat.count, dtype=torch.int64, device=flat.keys.device)
    o1, o2 = threefry2x32(flat.keys[:, 0:1], flat.keys[:, 1:2], 0, c)
    bits = o1 ^ o2
    if as_bits:
        return bits
    u = bits_to_unit(bits.T)
    lo = torch.tensor(flat.lo, dtype=torch.float32, device=u.device)
    scale = torch.tensor(flat.scale, dtype=torch.float32, device=u.device)
    return lo + scale * u


def draw_flat_plain(flat: Flat) -> tuple:
    """K-rng's draw lane by lane in torch ops on ``flat``: (the planar
    (sum of counts, n) float32 words, ``lo + scale * u`` with two float32
    roundings; the chain's (n, 2) keys where ``flat.key_out``, else
    None)."""
    lane = torch.arange(flat.n, dtype=torch.int64, device=flat.keys.device)
    k = flat.keys[lane * flat.key_stride]
    k1, k2 = k[:, 0], k[:, 1]
    if flat.data is not None:
        k1, k2 = threefry2x32(k1, k2, 0, flat.data[lane * flat.data_stride] & M32)
    for tag in flat.tags:
        k1, k2 = threefry2x32(k1, k2, 0, tag)
    rows = []
    for suffix, count, lo, scale in flat.draws:
        s1, s2 = k1, k2
        for tag in suffix:
            s1, s2 = threefry2x32(s1, s2, 0, tag)
        c = torch.arange(count, dtype=torch.int64, device=flat.keys.device)
        o1, o2 = threefry2x32(s1[None, :], s2[None, :], 0, c[:, None])
        u = bits_to_unit(o1 ^ o2)
        lo_t, scale_t = (torch.tensor(v, dtype=torch.float32, device=u.device) for v in (lo, scale))
        rows.append(lo_t + scale_t * u)
    out = torch.cat(rows) if rows else torch.empty((0, flat.n), dtype=torch.float32,
                                                   device=flat.keys.device)
    return out, (torch.stack([k1, k2], dim=-1) if flat.key_out else None)


class _DrawSpec(ctypes.Structure):
    """`csrc/threefry.cu` DrawSpec."""

    _fields_ = [("tags", ctypes.c_uint32 * MAX_SUFFIX), ("n_tags", ctypes.c_int),
                ("count", ctypes.c_int), ("lo", ctypes.c_float), ("scale", ctypes.c_float)]


class _DrawParams(ctypes.Structure):
    """`csrc/threefry.cu` DrawParams, passed by value to the kernel."""

    _fields_ = [("keys", ctypes.c_void_p), ("data", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("key_out", ctypes.c_void_p), ("key_stride", ctypes.c_int),
                ("data_stride", ctypes.c_int), ("n", ctypes.c_int), ("n_tags", ctypes.c_int),
                ("n_draws", ctypes.c_int), ("tags", ctypes.c_uint32 * MAX_TAGS),
                ("draws", _DrawSpec * MAX_DRAWS)]


def _draw_params(flat: Flat, out: torch.Tensor, key_out) -> "_DrawParams":
    """The call's parameter struct: the call site's template with this
    call's pointers, strides and lanes."""
    p = _DrawParams.from_buffer_copy(flat.template)
    p.keys, p.out, p.n = flat.keys.data_ptr(), out.data_ptr(), flat.n
    p.key_stride, p.data_stride = flat.key_stride, flat.data_stride
    if flat.data is not None:
        p.data = flat.data.data_ptr()
    if key_out is not None:
        p.key_out = key_out.data_ptr()
    return p


def _on_card(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def threefry_fold(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of ``data`` (an int or an integer tensor,
    taken mod 2^32, broadcasting against the batch) into each key of
    ``keys`` (..., 2): the broadcast batch of keys, int64. CPU tensors take
    `fold_in_plain`; CUDA tensors launch K-rng."""
    flat = _prepare_fold(keys, data)
    if keys.device.type == "cpu":
        return fold_in_plain(keys, data)
    _on_card("threefry_fold", keys)
    out = torch.empty((*flat.shape, 2), dtype=torch.int64, device=keys.device)
    if flat.n == 0:
        return out
    code = _build.library().lib.rpt_threefry_fold(
        flat.keys.data_ptr(), flat.key_stride,
        None if flat.data is None else flat.data.data_ptr(), flat.data_stride,
        flat.data_scalar, flat.n, out.data_ptr(), _build.stream_of(keys))
    threefry_fold.launches += 1
    _build.check(code, "threefry_fold")
    return out


def threefry_split(key: torch.Tensor, n: int) -> torch.Tensor:
    """The partitionable ``jax.random.split(key, n)``: (n, 2) int64, key i
    the hash of the counter (0, i). CPU tensors take `keys_for_plain`;
    CUDA tensors launch K-rng."""
    flat = _prepare_split(key, n)
    if key.device.type == "cpu":
        return keys_for_plain(key, flat.n)
    _on_card("threefry_split", key)
    out = torch.empty((flat.n, 2), dtype=torch.int64, device=key.device)
    if flat.n == 0:
        return out
    code = _build.library().lib.rpt_threefry_split(flat.keys.data_ptr(), flat.n, out.data_ptr(),
                                                   _build.stream_of(key))
    threefry_split.launches += 1
    _build.check(code, "threefry_split")
    return out


def threefry_uniform(keys: torch.Tensor, count: int, lo=0.0, hi=1.0) -> tuple:
    """``count`` independent uniforms a key in [lo, hi), as
    ``jax.random.uniform(key, (count,))`` then ``lo + (hi - lo) * u`` in
    float32: a tuple of ``count`` float32 tensors of the keys' batch
    shape (each contiguous). CPU tensors take the plain version; CUDA
    tensors launch K-rng."""
    flat = _prepare_words("threefry_uniform", keys, count, lo, hi)
    if keys.device.type == "cpu":
        return uniforms_plain(keys, flat.count, lo, hi)
    _on_card("threefry_uniform", keys)
    out = torch.empty((flat.count, flat.n), dtype=torch.float32, device=keys.device)
    if flat.n:
        code = _build.library().lib.rpt_threefry_uniform(
            flat.keys.data_ptr(), flat.n, flat.count, flat.lo, flat.scale, out.data_ptr(),
            _build.stream_of(keys))
        threefry_uniform.launches += 1
        _build.check(code, "threefry_uniform")
    return tuple(out[c].view(flat.shape) for c in range(flat.count))


def threefry_bits(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit words for counters 0..count-1 a key: (..., count) int64, the
    partitionable ``jax.random.bits`` layout. CPU tensors take
    `random_bits_plain`; CUDA tensors launch K-rng."""
    flat = _prepare_words("threefry_bits", keys, count)
    if keys.device.type == "cpu":
        return random_bits_plain(keys, flat.count)
    _on_card("threefry_bits", keys)
    out = torch.empty((*flat.shape, flat.count), dtype=torch.int64, device=keys.device)
    if flat.n:
        code = _build.library().lib.rpt_threefry_bits(
            flat.keys.data_ptr(), flat.n, flat.count, out.data_ptr(), _build.stream_of(keys))
        threefry_bits.launches += 1
        _build.check(code, "threefry_bits")
    return out


def threefry_draw(keys: torch.Tensor, data, tags, draws, key_out: bool = False) -> tuple:
    """Derive and draw: each lane's key is its key of ``keys`` (..., 2),
    or the one key, folded with its word of ``data`` (an integer tensor
    broadcasting against the batch, taken mod 2^32; or None) and then with
    each static tag of ``tags`` (at most `MAX_TAGS`); from it each `Draw`
    of ``draws`` (at most `MAX_DRAWS`) folds its own suffix and draws its
    ``count`` uniforms in [lo, hi). Bit for bit the unfused ``fold_in``
    chain then ``uniform`` (`draw_plain`). Returns (the draws' floats in
    order, one tensor of the broadcast batch shape a word, each
    contiguous; the chain's keys (..., 2) where ``key_out``, else None).
    CPU tensors take `draw_plain`; CUDA tensors launch K-rng once."""
    flat = _prepare_draw(keys, data, tags, draws, key_out)
    if keys.device.type == "cpu":
        return draw_plain(keys, data, flat.tags, draws, key_out)
    _on_card("threefry_draw", keys)
    rows = sum(spec[1] for spec in flat.draws)
    out = torch.empty((rows, flat.n), dtype=torch.float32, device=keys.device)
    kout = (torch.empty((*flat.shape, 2), dtype=torch.int64, device=keys.device)
            if flat.key_out else None)
    if flat.n:
        if flat.keys.data_ptr() % 16:  # the kernel loads a key row as 16 bytes
            flat.keys = flat.keys.clone()
        params = _draw_params(flat, out, kout)
        code = _build.library().lib.rpt_threefry_draw(
            ctypes.byref(params), _build.stream_of(keys))
        threefry_draw.launches += 1
        _build.check(code, "threefry_draw")
    floats = out.unbind(0)
    if flat.shape != (flat.n,):
        floats = tuple(f.view(flat.shape) for f in floats)
    return floats, kout


threefry_fold.launches = 0
threefry_split.launches = 0
threefry_uniform.launches = 0
threefry_bits.launches = 0
threefry_draw.launches = 0
