"""K-rng's host side against `jax.random`, bit for bit, on the CPU.

Every call form the port makes of its RNG (`rpt_tpu_torch/sampling.py`
through `rpt_tpu_torch/ops/threefry.py`) is flattened by the wrappers'
`_prepare_*` into the arguments K-rng (`csrc/threefry.cu`) takes; the
kernel's per-lane arithmetic on those arguments (`fold_flat_plain`,
`words_flat_plain`, `draw_flat_plain`) must give `jax.random`'s keys,
words and floats (through `rpt_tpu.sampling` where it has the call) on
every element, and so must the wrappers, which run the plain version for
CPU tensors. The draw form (a key's chain of folds and several draws in
one launch) is held to the JAX package's fold chains then ``uniform``,
and `sampling.KeyPath` (keys with folds pending) to the unfused chain. The kernel
itself is held to the same per-lane arithmetic on the card
(`tests/test_torch_kernels.py::test_threefry_kernels_match_plain_on_card`,
`chip_smoke.py` `[K-rng]`).
"""

import ctypes
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


D = tf.Draw


def _jax_chain(jkeys, data, tags):
    """The JAX package's keys of a draw's chain: ``fold_in`` of each lane's
    data word (where given), then `rpt_tpu.sampling.fold` of each tag (mod
    2^32)."""
    if data is not None:
        jkeys = _fold_ref(jkeys, jnp.asarray((data & M32).astype(np.uint32)))
    for tag in tags:
        tag &= M32  # jax takes uint32 data
        jkeys = js.fold(jkeys, tag) if jkeys.ndim == 1 else _fold_ref(jkeys, tag)
    return jkeys


def _jax_draws(jkeys, data, tags, draws) -> list:
    """Each draw's floats as the JAX package makes them: its suffix folded
    into the chain's keys, then ``lo + (hi - lo) * jax.random.uniform(k,
    (count,))`` (`rpt_tpu.sampling.uniform`'s rounding), word by word."""
    chain = _jax_chain(jkeys, data, tags)
    out = []
    for d in draws:
        k = _jax_chain(chain, None, d.tags)
        flat = jax.random.wrap_key_data(jax.random.key_data(k).reshape(-1, 2))
        u = jax.vmap(lambda key, c=d.count: jax.random.uniform(key, (c,), dtype=jnp.float32))(
            flat)
        if not (d.lo == 0.0 and d.hi == 1.0):
            u = d.lo + (d.hi - d.lo) * u
        out += [_f32_bits(u[:, c]).reshape(np.shape(k)) for c in range(d.count)]
    return out


CAMERA = (D((1,), 1, -1.0 / 600.0, 1.0 / 600.0), D((2,), 1, -1.0 / 600.0, 1.0 / 600.0),
          D((3, 0xD0F), 2))


def _draw_case(name):
    """(keys, data as int64 numpy or None, tags, draws, key_out) of one
    draw form the paths make."""
    rng = np.random.default_rng(DRAW_FORMS.index(name))
    if name == "one key x pixel ids, the camera's jitter and lens":
        return ts.key(2**33 + 9), _wide_data(rng, N), (7,), CAMERA, False
    if name == "chain of 1, no suffix":
        return _batch(21), None, (5,), (D(),), False
    if name == "chain of 2, count 2":
        return _batch(22), None, (4, 3), (D((0x9A,), 2),), False
    if name == "chain of 3, sample_f's two draws":
        return _batch(23), None, (4, 2, 3), (D((0xB5DF,), 2), D((0xF7E5,))), False
    if name == "chain of 4, the cube light's three draws":
        return _batch(24), None, (4, 1, 2, 0x1100), tuple(D((t,)) for t in (0xC1, 0xC2, 0xC3)), False
    if name == "eight draws of counts 1-3 and suffixes of 0-2 tags":
        draws = tuple(D(tuple(range(i % 3)) if i % 3 else (), 1 + i % 3, -0.25, 0.25)
                      for i in range(tf.MAX_DRAWS))
        return _batch(25), None, (1,), draws, False
    if name == "key out, one key x pixel ids":
        return ts.key(3), _wide_data(rng, N), (7, 4), (), True
    if name == "key out and a draw, (A, B) keys":
        return _batch(26, 35 * 22).reshape(35, 22, 2), None, (2**32 + 3, -1), (D((), 3),), True
    if name == "batch x batch data, a full chain":
        return _batch(27), _wide_data(rng, N), tuple(range(tf.MAX_TAGS)), (D((1, 2), 2),), True
    raise KeyError(name)


DRAW_FORMS = ("one key x pixel ids, the camera's jitter and lens", "chain of 1, no suffix",
              "chain of 2, count 2", "chain of 3, sample_f's two draws",
              "chain of 4, the cube light's three draws",
              "eight draws of counts 1-3 and suffixes of 0-2 tags", "key out, one key x pixel ids",
              "key out and a draw, (A, B) keys", "batch x batch data, a full chain")


@pytest.mark.parametrize("form", DRAW_FORMS)
def test_draw_flat_arguments_match_jax(form):
    """The draw form's flat arguments, hashed lane by lane as the kernel
    does (`draw_flat_plain`), give the JAX package's floats (fold chains
    then ``uniform`` at [lo, hi)) and keys bit for bit; so do the wrapper
    and `sampling.draw` on the CPU, and the unfused composition
    `draw_plain`."""
    keys, data, tags, draws, key_out = _draw_case(form)
    tdata = None if data is None else torch.tensor(data)
    jk = _jkeys(keys)
    want = _jax_draws(jk, data, tags, draws)
    want_keys = _bits(_jax_chain(jk, data, tags)) if key_out else None
    flat = tf._prepare_draw(keys, tdata, tags, draws, key_out)
    assert flat.keys.is_contiguous() and flat.key_stride in (0, 1)
    assert flat.tags == tuple(t & M32 for t in tags) and len(flat.draws) == len(draws)
    planar, flat_keys = tf.draw_flat_plain(flat)
    assert planar.shape == (sum(d.count for d in draws), flat.n)
    for row, w in zip(planar, want):
        assert np.array_equal(_f32_bits(row.numpy()).reshape(w.shape), w)
    for floats, out_keys in (tf.threefry_draw(keys, tdata, tags, draws, key_out),
                             tf.draw_plain(keys, tdata, tags, draws, key_out)):
        assert len(floats) == len(want)
        for got, w in zip(floats, want):
            assert np.array_equal(_f32_bits(got.numpy()), w)
        if key_out:
            assert np.array_equal(out_keys.numpy(), want_keys)
    if key_out:
        assert np.array_equal(flat_keys.reshape(want_keys.shape).numpy(), want_keys)
    if draws:
        path = ts.KeyPath(keys, tdata, tags)
        for got, w in zip(ts.draw(path, *draws), want):
            assert np.array_equal(_f32_bits(got.numpy()), w)


def test_key_path_materialises_the_unfused_chain(monkeypatch):
    """A `sampling.KeyPath` folds and indexes without a call to K-rng; its
    keys, and its draws, are those of the unfused `fold_in`/`fold` chain on
    key tensors; a chain past `MAX_TAGS` folds is materialised and goes
    on; on the CPU its launches are the plain version's."""
    rng = np.random.default_rng(31)
    key, pids = ts.key(2**40 + 3), torch.tensor(_wide_data(rng, N))
    calls = []
    real = tf.threefry_draw
    monkeypatch.setattr(tf, "threefry_draw", lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    path = ts.key_path(key, pids).fold(9)
    trace = ts.fold(path, 4)
    level = ts.fold(ts.fold(trace, 2), 3)
    sel = torch.tensor(rng.permutation(N)[:300])
    assert calls == [] and isinstance(level[sel], ts.KeyPath) and level.tags == (9, 4, 2, 3)
    unfused = ts.fold(ts.fold(ts.fold(ts.fold(ts.fold_in(key, pids), 9), 4), 2), 3)
    assert torch.equal(level.keys(), unfused)
    assert torch.equal(level[sel].keys(), unfused[sel])
    assert torch.equal(level[10:20].keys(), unfused[10:20])
    batch = ts.key_path(unfused)
    assert batch.keys() is unfused and ts.key_path(batch) is batch
    mask = torch.tensor(rng.random(N) < 0.5)
    assert torch.equal(batch.fold(1)[mask].keys(), ts.fold(unfused, 1)[mask])
    deep = level
    for t in range(tf.MAX_TAGS + 3):
        deep = deep.fold(t)
        unfused = ts.fold(unfused, t)
    assert len(deep.tags) <= tf.MAX_TAGS and torch.equal(deep.keys(), unfused)
    # the path's draws are those of the unfused keys
    assert torch.equal(ts.uniform(level, -0.25, 0.25), ts.uniform(level.keys(), -0.25, 0.25))
    for a, b in zip(ts.uniform2(level.fold(0x9A)), ts.uniform2(ts.fold(level.keys(), 0x9A))):
        assert torch.equal(a, b)
    for a, b in zip(ts.uniform3(level), ts.uniform3(level.keys())):
        assert torch.equal(a, b)
    assert np.array_equal(_f32_bits(ts.uniform(level).numpy()),
                          _f32_bits(js.uniform(_jax_chain(_jkeys(key), _wide_data(
                              np.random.default_rng(31), N), (9, 4, 2, 3)))))
    with pytest.raises(IndexError):
        ts.key_path(key)[0:1]
    with pytest.raises(ValueError):
        ts.key_path(path, pids)


def test_draw_struct_matches_the_kernel():
    """`_DrawParams`/`_DrawSpec` have the layout `csrc/threefry.cu` pins
    with its static_asserts, and `_draw_params` fills them: the call
    site's tags and draws from the cached template, the call's pointers,
    strides and lanes."""
    with open(os.path.join(_build.CSRC_DIR, "threefry.cu")) as f:
        src = f.read()
    pinned = dict(re.findall(r"offsetof\(DrawParams, (\w+)\) == (\d+)", src))
    assert {k: int(v) for k, v in pinned.items()} == {
        name: getattr(tf._DrawParams, name).offset for name in pinned}
    assert int(re.search(r"sizeof\(DrawParams\) == (\d+)", src).group(1)) == \
        ctypes.sizeof(tf._DrawParams)
    assert int(re.search(r"sizeof\(DrawSpec\) == (\d+)", src).group(1)) == \
        ctypes.sizeof(tf._DrawSpec)
    for const, value in (("kMaxTags", tf.MAX_TAGS), ("kMaxDraws", tf.MAX_DRAWS),
                         ("kMaxSuffix", tf.MAX_SUFFIX)):
        assert re.search(rf"constexpr int {const} = {value};", src)
    key, pids = ts.key(5), torch.arange(N)
    flat = tf._prepare_draw(key, pids, (7, -1), CAMERA, True)
    out, kout = torch.empty((4, N)), torch.empty((N, 2), dtype=torch.int64)
    p = tf._draw_params(flat, out, kout)
    assert (p.keys, p.data, p.out, p.key_out) == (flat.keys.data_ptr(), pids.data_ptr(),
                                                  out.data_ptr(), kout.data_ptr())
    assert (p.key_stride, p.data_stride, p.n, p.n_tags, p.n_draws) == (0, 1, N, 2, 3)
    assert list(p.tags)[:2] == [7, M32]
    lens = p.draws[2]
    assert (list(lens.tags), lens.n_tags, lens.count, lens.lo, lens.scale) == ([3, 0xD0F], 2, 2,
                                                                              0.0, 1.0)
    assert p.draws[0].lo == np.float32(-1.0 / 600.0) and p.draws[0].scale == np.float32(2 / 600)
    assert tf._draw_params(tf._prepare_draw(key, None, (), (D(),), False), out, None).data is None


def test_draw_rejects_bad_inputs():
    """Chains and suffixes too long, too many or no draws, bad counts,
    ranges and data, and keys of the wrong type raise; keys on neither the
    CPU nor a card raise instead of taking the plain version."""
    keys = _batch(16, 8)
    bad = [
        lambda: tf.threefry_draw(keys, None, tuple(range(tf.MAX_TAGS + 1)), (D(),)),
        lambda: tf.threefry_draw(keys, None, (), (D(),) * (tf.MAX_DRAWS + 1)),
        lambda: tf.threefry_draw(keys, None, (), (D((1, 2, 3)),)),
        lambda: tf.threefry_draw(keys, None, (), ()),
        lambda: tf.threefry_draw(keys, None, (), (D((), 0),)),
        lambda: tf.threefry_draw(keys, None, (1.5,), (D(),)),
        lambda: tf.threefry_draw(keys, None, (), ((1, 1, 0.0, 1.0),)),
        lambda: tf.threefry_draw(keys, None, (), (D((), 1, "a", 1.0),)),
        lambda: tf.threefry_draw(keys, None, ([1],), (D(),)),
        lambda: tf.threefry_draw(keys, torch.ones(8), (), (D(),)),
        lambda: tf.threefry_draw(keys, torch.arange(7), (), (D(),)),
        lambda: tf.threefry_draw(keys, torch.arange(8, device="meta"), (), (D(),)),
        lambda: tf.threefry_draw(keys.to(torch.int32), None, (), (D(),)),
    ]
    for i, call in enumerate(bad):
        with pytest.raises((ValueError, RuntimeError)):
            call()
            pytest.fail(f"bad call {i} was accepted")
    with pytest.raises(ValueError, match="unsupported device"):
        tf.threefry_draw(keys.to("meta"), None, (1,), (D(),))


def test_draw_on_the_cpu_takes_the_plain_version(monkeypatch):
    """For CPU tensors the draw form and a `KeyPath`'s keys run
    `draw_plain`, never build or launch K-rng, and count no launch."""
    def no_library():
        raise AssertionError("the CPU path reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    called = []
    real = tf.draw_plain
    monkeypatch.setattr(tf, "draw_plain", lambda *a, **k: called.append(1) or real(*a, **k))
    before = tf.threefry_draw.launches
    path = ts.key_path(ts.key(1), torch.arange(50)).fold(2)
    ts.draw(path, *CAMERA)
    path.keys()
    ts.uniform(path.fold(3))
    assert len(called) == 3 and tf.threefry_draw.launches == before
    empty = ts.key_path(torch.zeros((0, 2), dtype=torch.int64)).fold(1)
    assert [u.shape for u in ts.draw(empty, D((), 2))] == [(0,), (0,)]
    assert empty.keys().shape == (0, 2)


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
    int or drop the stream), K-rng's five among them."""
    found = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        found.update(_extern_arities(path))
    assert {"rpt_threefry_fold", "rpt_threefry_split", "rpt_threefry_uniform",
            "rpt_threefry_bits", "rpt_threefry_draw"} <= set(found)
    assert found == {name: len(args) for name, args in _build._SIGNATURES.items()}
    arities = _extern_arities(os.path.join(_build.CSRC_DIR, "threefry.cu"))
    assert arities == {"rpt_threefry_fold": 8, "rpt_threefry_split": 4,
                       "rpt_threefry_uniform": 7, "rpt_threefry_bits": 5,
                       "rpt_threefry_draw": 2}
