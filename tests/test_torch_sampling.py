"""The port's threefry2x32 RNG against `jax.random` (bit for bit) and its
samplers against `rpt_tpu.sampling` (same inputs, atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpt_tpu import sampling as js
from rpt_tpu.vec import Vec3 as JVec3
from rpt_tpu_torch import sampling as ts
from rpt_tpu_torch.vec import Vec3 as TVec3

N = 1000


def _key_bits(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_key_and_keys_for_bits(seed):
    jk = jax.random.key(seed)
    tk = ts.key(seed)
    assert np.array_equal(tk.numpy(), _key_bits(jk))
    assert np.array_equal(ts.keys_for(tk, N).numpy(), _key_bits(js.keys_for(jk, N)))


def test_fold_bits():
    jk = js.keys_for(jax.random.key(7), N)
    tk = ts.keys_for(ts.key(7), N)
    for tag in (0, 1, 0xB5DF, 2**32 - 1):
        assert np.array_equal(ts.fold(tk, tag).numpy(), _key_bits(js.fold(jk, tag)))
    # per-lane data (the renderer folds pixel ids into one key)
    ids = np.arange(N, dtype=np.int64) * 7919
    jf = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(jnp.asarray(ids, jnp.int32))
    assert np.array_equal(ts.fold_in(ts.key(3), torch.tensor(ids)).numpy(), _key_bits(jf))


def test_uniform_bits():
    jk = js.fold(js.keys_for(jax.random.key(11), N), 5)
    tk = ts.fold(ts.keys_for(ts.key(11), N), 5)
    assert np.array_equal(_f32_bits(ts.uniform(tk).numpy()), _f32_bits(js.uniform(jk)))
    assert np.array_equal(_f32_bits(ts.uniform(tk, -0.25, 0.25).numpy()),
                          _f32_bits(js.uniform(jk, -0.25, 0.25)))
    for tf, jf, m in ((ts.uniform2, js.uniform2, 2), (ts.uniform3, js.uniform3, 3)):
        t_out, j_out = tf(tk), jf(jk)
        for i in range(m):
            assert np.array_equal(_f32_bits(t_out[i].numpy()), _f32_bits(j_out[i]))


def _unit_vectors(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_samplers_agree():
    rng = np.random.default_rng(0)
    r1 = rng.random(N, dtype=np.float32)
    r2 = rng.random(N, dtype=np.float32)
    shin = rng.uniform(1.0, 50.0, N).astype(np.float32)
    n = _unit_vectors(rng, N)
    jn = JVec3.from_array(n)
    tn = TVec3.from_array(n)
    jr1, jr2, tr1, tr2 = jnp.asarray(r1), jnp.asarray(r2), torch.tensor(r1), torch.tensor(r2)

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-6)

    for jf, tf in ((js.unit_disc, ts.unit_disc),):
        for a, b in zip(jf(jr1, jr2), tf(tr1, tr2)):
            close(a, b)
    for a, b in zip(js.unit_circle(jr1), ts.unit_circle(tr1)):
        close(a, b)
    close(js.uniform_sphere(jr1, jr2).to_array(), ts.uniform_sphere(tr1, tr2).to_array())
    for jf, tf in ((js.cosine_hemisphere, ts.cosine_hemisphere),
                   (js.uniform_hemisphere, ts.uniform_hemisphere)):
        (jd, jp), (td, tp) = jf(jr1, jr2, jn), tf(tr1, tr2, tn)
        close(jd.to_array(), td.to_array())
        close(jp, tp)
    (jd, jp), (td, tp) = js.phong_lobe(jr1, jr2, jnp.asarray(shin), jn), ts.phong_lobe(
        tr1, tr2, torch.tensor(shin), tn)
    close(jd.to_array(), td.to_array())
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), rtol=1e-5)
