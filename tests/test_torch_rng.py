"""K-rng's host side against `jax.random`, bit for bit, on the CPU.

Every call form the port makes of its RNG (`rpt_tpu_torch/sampling.py`
through `rpt_tpu_torch/ops/threefry.py`) is flattened by the wrappers'
`_prepare_*` into the arguments K-rng (`csrc/threefry.cu`) takes; the
kernel's per-lane arithmetic on those arguments (`fold_flat_plain`,
`words_flat_plain`) must give `jax.random`'s keys, words and floats
(through `rpt_tpu.sampling` where it has the call) on every element, and so
must the wrappers, which run the plain version for CPU tensors. The kernel
itself is held to the same per-lane arithmetic on the card
(`tests/test_torch_kernels.py::test_threefry_kernels_match_plain_on_card`,
`chip_smoke.py` `[K-rng]`).
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpt_tpu import sampling as js
from rpt_tpu_torch import sampling as ts
from rpt_tpu_torch.ops import _build, threefry as tf

N = 777  # no multiple of the kernel's 256-thread block
M32 = 0xFFFFFFFF


def _jkeys(keys: torch.Tensor):
    """The port's int64 key words as typed jax keys of the same batch shape."""
    return jax.random.wrap_key_data(jnp.asarray(keys.numpy().astype(np.uint32)))


def _bits(jkeys) -> np.ndarray:
    return np.asarray(jax.random.key_data(jkeys)).astype(np.int64)


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _batch(seed: int, n: int = N) -> torch.Tensor:
    return ts.fold(ts.keys_for(ts.key(seed), n), 0x77)


def _fold_ref(jkeys, data):
    """``jax.random.fold_in`` lane by lane over typed keys of any batch
    shape, ``data`` an int or a uint32 array of the same batch shape."""
    if jkeys.ndim == 0:
        if jnp.ndim(data) == 0:
            return jax.random.fold_in(jkeys, data)
        return jax.vmap(lambda d: jax.random.fold_in(jkeys, d))(data)
    if isinstance(data, int):
        return jax.vmap(lambda k: _fold_ref(k, data))(jkeys)
    return jax.vmap(_fold_ref)(jkeys, data)


def _wide_data(rng, n: int) -> np.ndarray:
    """int64 data with negative values and values >= 2^31 (and >= 2^32)."""
    return np.concatenate([rng.integers(-2**40, 2**40, n - 6),
                           [-1, -2**31, 2**31, 2**32 - 1, 2**32 + 5, 0]]).astype(np.int64)


def _fold_case(name):
    """(keys, data, the jax keys) of one fold form."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    if name == "scalar key x int":
        k = ts.key(2**33 + 9)
        return k, 0xB5DF, _fold_ref(_jkeys(k), 0xB5DF)
    if name == "scalar key x wide data":
        k, d = ts.key(3), _wide_data(rng, N)
        return k, torch.tensor(d), _fold_ref(_jkeys(k), jnp.asarray((d & M32).astype(np.uint32)))
    if name == "batch x int":
        k = _batch(5)
        return k, 2**32 - 1, js.fold(_jkeys(k), 2**32 - 1)
    if name == "batch x batch":
        k, d = _batch(6), _wide_data(rng, N)
        return k, torch.tensor(d), _fold_ref(_jkeys(k), jnp.asarray((d & M32).astype(np.uint32)))
    if name == "(A, B) keys x int":
        k = _batch(7, 35 * 22).reshape(35, 22, 2)
        return k, 4, _fold_ref(_jkeys(k), 4)
    if name == "(A, B) keys x (A, B) data":
        k, d = _batch(8, 35 * 22).reshape(35, 22, 2), _wide_data(rng, 35 * 22).reshape(35, 22)
        return k, torch.tensor(d), _fold_ref(_jkeys(k), jnp.asarray((d & M32).astype(np.uint32)))
    # a key batch whose rows repeat under broadcasting: (A, 1) keys x (B,) data
    k, d = _batch(9, 35).reshape(35, 1, 2), _wide_data(rng, 22)
    jk = _jkeys(k.expand(35, 22, 2).contiguous())
    du = jnp.asarray(np.broadcast_to((d & M32).astype(np.uint32), (35, 22)))
    return k, torch.tensor(d), _fold_ref(jk, du)


FOLD_FORMS = ("scalar key x int", "scalar key x wide data", "batch x int", "batch x batch",
              "(A, B) keys x int", "(A, B) keys x (A, B) data", "(A, 1) keys x (B,) data")


@pytest.mark.parametrize("form", FOLD_FORMS)
def test_fold_flat_arguments_match_jax(form):
    """The kernel's flat arguments of each fold form, hashed lane by lane,
    are `jax.random.fold_in`'s keys; so are the wrapper's and
    `sampling.fold_in`'s on the CPU."""
    keys, data, ref = _fold_case(form)
    want = _bits(ref)
    flat = tf._prepare_fold(keys, data)
    assert flat.keys.is_contiguous() and flat.key_stride in (0, 1)
    assert flat.data is None or (flat.data.dtype == torch.int64 and flat.data_stride in (0, 1))
    assert flat.n == int(np.prod(want.shape[:-1]))
    got = tf.fold_flat_plain(flat).reshape(*flat.shape, 2)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tf.threefry_fold(keys, data).numpy(), want)
    assert np.array_equal(ts.fold_in(keys, data).numpy(), want)


def test_fold_strides_by_form():
    """One key for every lane is stride 0 (no copy); a batch is stride 1;
    an int is the scalar argument, taken mod 2^32."""
    k, b = ts.key(1), _batch(1)
    flat = tf._prepare_fold(k, torch.arange(5))
    assert (flat.key_stride, flat.data_stride, flat.n, flat.keys.shape) == (0, 1, 5, (1, 2))
    flat = tf._prepare_fold(b, -1)
    assert (flat.key_stride, flat.data, flat.data_scalar) == (1, None, M32)
    assert flat.keys.data_ptr() == b.data_ptr()
    flat = tf._prepare_fold(b, torch.tensor(3))
    assert flat.data is None and flat.data_scalar == 3


@pytest.mark.parametrize("n", [1, N, 4096])
def test_split_matches_jax(n):
    """`keys_for` (the partitionable `jax.random.split`): lane i hashes the
    counter (0, i) under the one key."""
    k = ts.key(2**31 + 5)
    want = _bits(js.keys_for(jax.random.key(2**31 + 5), n))
    flat = tf._prepare_split(k, n)
    assert flat.key_stride == 0 and flat.lane_data and flat.n == n
    assert np.array_equal(tf.fold_flat_plain(flat).numpy(), want)
    assert np.array_equal(ts.keys_for(k, n).numpy(), want)


UNIFORM_RANGES = ((-1.0 / 32.0, 1.0 / 32.0), (-1.0 / 600.0, 1.0 / 600.0), (-0.25, 0.25),
                  (0.0, 1.0))


@pytest.mark.parametrize("lo,hi", UNIFORM_RANGES)
def test_uniform_matches_jax(lo, hi):
    """`uniform(keys, lo, hi)` at the ranges the port draws (the camera's
    jitter of +-1/dim, the lights' +-0.25, the unit interval): the kernel's
    planar output, two float32 roundings, is `rpt_tpu.sampling.uniform`'s
    floats bit for bit."""
    keys = _batch(11)
    want = _f32_bits(js.uniform(_jkeys(keys), lo, hi))
    flat = tf._prepare_words("threefry_uniform", keys, 1, lo, hi)
    assert flat.lo == np.float32(lo) and flat.scale == np.float32(hi - lo)
    got = tf.words_flat_plain(flat, as_bits=False)
    assert got.shape == (1, N)
    assert np.array_equal(_f32_bits(got[0].numpy()), want)
    assert np.array_equal(_f32_bits(ts.uniform(keys, lo, hi).numpy()), want)


@pytest.mark.parametrize("count", [2, 3])
def test_uniform2_uniform3_match_jax(count):
    keys = _batch(12)
    want = (js.uniform2 if count == 2 else js.uniform3)(_jkeys(keys))
    got = tf.words_flat_plain(tf._prepare_words("threefry_uniform", keys, count), as_bits=False)
    mine = (ts.uniform2 if count == 2 else ts.uniform3)(keys)
    assert got.shape == (count, N) and len(mine) == count
    for c in range(count):
        assert np.array_equal(_f32_bits(got[c].numpy()), _f32_bits(want[c]))
        assert np.array_equal(_f32_bits(mine[c].numpy()), _f32_bits(want[c]))


def test_words_of_batched_keys_match_jax():
    """Keys of shape (A, B, 2): uniform, uniform3 and the raw words
    (`random_bits`, `jax.random.bits`) keep the batch shape."""
    keys = _batch(13, 35 * 22).reshape(35, 22, 2)
    jk = _jkeys(keys)
    u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (3,), dtype=jnp.float32)))(jk)
    words = jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (3,), dtype=jnp.uint32)))(jk)
    flat = tf._prepare_words("threefry_uniform", keys, 3)
    assert flat.shape == (35, 22) and flat.n == 35 * 22
    planar = tf.words_flat_plain(flat, as_bits=False).reshape(3, 35, 22)
    mine = ts.uniform3(keys)
    for c in range(3):
        assert np.array_equal(_f32_bits(planar[c].numpy()), _f32_bits(u[..., c]))
        assert np.array_equal(_f32_bits(mine[c].numpy()), _f32_bits(u[..., c]))
    assert np.array_equal(_f32_bits(ts.uniform(keys).numpy()),
                          _f32_bits(jax.vmap(jax.vmap(jax.random.uniform))(jk)))
    want = np.asarray(words).astype(np.int64)
    flat = tf._prepare_words("threefry_bits", keys, 3)
    assert np.array_equal(tf.words_flat_plain(flat, as_bits=True).reshape(35, 22, 3).numpy(), want)
    assert np.array_equal(ts.random_bits(keys, 3).numpy(), want)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """For CPU tensors every wrapper calls its plain version, never builds
    or launches K-rng, and counts no launch."""
    def no_library():
        raise AssertionError("the CPU path reached the kernel library")

    keys = _batch(14, 64)
    monkeypatch.setattr(_build, "library", no_library)
    called = []
    for name in ("fold_in_plain", "keys_for_plain", "random_bits_plain", "uniforms_plain"):
        plain = getattr(tf, name)
        monkeypatch.setattr(tf, name, lambda *a, _p=plain, _n=name, **k: called.append(_n)
                            or _p(*a, **k))
    wrappers = (tf.threefry_fold, tf.threefry_split, tf.threefry_uniform, tf.threefry_bits)
    before = [w.launches for w in wrappers]
    ts.fold(keys, 3)
    ts.fold_in(ts.key(1), torch.arange(10))
    ts.keys_for(ts.key(1), 10)
    ts.random_bits(keys, 2)
    ts.uniform(keys, -0.5, 0.5)
    ts.uniform2(keys)
    ts.uniform3(keys)
    # (uniforms_plain draws its words through random_bits_plain)
    assert called == ["fold_in_plain", "fold_in_plain", "keys_for_plain", "random_bits_plain",
                      *["uniforms_plain", "random_bits_plain"] * 3]
    assert [w.launches for w in wrappers] == before


def test_wrappers_reject_bad_inputs():
    """Wrong key dtypes and shapes, non-integer data, data on another
    device, bad counts and ranges raise; a tensor on neither the CPU nor
    a CUDA card raises instead of taking the plain version."""
    keys = _batch(15, 8)
    bad = [
        lambda: tf.threefry_fold(keys.to(torch.int32), 1),
        lambda: tf.threefry_fold(keys.to(torch.float32), 1),
        lambda: tf.threefry_fold(keys[:, :1], 1),
        lambda: tf.threefry_fold(torch.zeros((8, 3), dtype=torch.int64), 1),
        lambda: tf.threefry_fold(keys, torch.ones(8)),
        lambda: tf.threefry_fold(keys, torch.ones(8, dtype=torch.bool)),
        lambda: tf.threefry_fold(keys, 1.5),
        lambda: tf.threefry_fold(keys, torch.arange(7)),
        lambda: tf.threefry_fold(keys, torch.arange(8, device="meta")),
        lambda: tf.threefry_split(keys, 4),
        lambda: tf.threefry_split(ts.key(1), -1),
        lambda: tf.threefry_split(ts.key(1).to(torch.int32), 4),
        lambda: tf.threefry_uniform(keys, 0),
        lambda: tf.threefry_uniform(keys, 1, torch.tensor(0.0), 1.0),
        lambda: tf.threefry_uniform(keys[:, :1], 1),
        lambda: tf.threefry_bits(keys, 0),
        lambda: tf.threefry_bits(keys.to(torch.int32), 1),
    ]
    for i, call in enumerate(bad):
        with pytest.raises((ValueError, RuntimeError)):
            call()
            pytest.fail(f"bad call {i} was accepted")
    meta = keys.to("meta")
    for call in (lambda: tf.threefry_fold(meta, 1), lambda: tf.threefry_split(meta[0], 4),
                 lambda: tf.threefry_uniform(meta, 2), lambda: tf.threefry_bits(meta, 2)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_empty_batches():
    keys = torch.zeros((0, 2), dtype=torch.int64)
    assert ts.fold(keys, 1).shape == (0, 2)
    assert ts.keys_for(ts.key(1), 0).shape == (0, 2)
    assert [u.shape for u in ts.uniform2(keys)] == [(0,), (0,)]
    assert tf.fold_flat_plain(tf._prepare_fold(keys, 1)).shape == (0, 2)


def _extern_arities(path: str) -> dict:
    """``extern "C"`` function name -> number of parameters, from the source."""
    with open(path) as f:
        src = f.read()
    out = {}
    for m in re.finditer(r'extern "C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', src):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = len(params)
    return out


def test_every_entry_point_has_its_signature():
    """Every ``extern "C"`` entry of `csrc/*.cu` has a `_SIGNATURES` entry
    of the same arity (ctypes would otherwise pass a pointer as a 32-bit
    int or drop the stream), K-rng's four among them."""
    found = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        found.update(_extern_arities(path))
    assert {"rpt_threefry_fold", "rpt_threefry_split", "rpt_threefry_uniform",
            "rpt_threefry_bits"} <= set(found)
    assert found == {name: len(args) for name, args in _build._SIGNATURES.items()}
    arities = _extern_arities(os.path.join(_build.CSRC_DIR, "threefry.cu"))
    assert arities == {"rpt_threefry_fold": 8, "rpt_threefry_split": 4,
                       "rpt_threefry_uniform": 7, "rpt_threefry_bits": 5}
