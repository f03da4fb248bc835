"""Port of ops/layers.py against the JAX package.  f32 results agree within
atol 1e-6 / rtol 1e-5: the two sum the moments and the softmax in
different orders; ids, masks and tables are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu_torch.ops import layers as TL

TOL = dict(atol=1e-6, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("d", [32, 512])
def test_layer_norm(d):
    rng = _rng(d)
    x = rng.normal(size=(4, 7, d)).astype(np.float32) * 3 + 1
    sc = rng.normal(size=d).astype(np.float32)
    bi = rng.normal(size=d).astype(np.float32)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(bi))
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_and_positional_encoding():
    rng = _rng(1)
    lut = rng.normal(size=(37, 32)).astype(np.float32)
    ids = rng.integers(0, 37, (3, 9)).astype(np.int64)
    e_t = TL.embed(torch.from_numpy(ids), torch.from_numpy(lut))
    e_j = JL.embed(jnp.asarray(ids), jnp.asarray(lut))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(TL._pe_table(50, 32), JL._pe_table(50, 32))
    for off in (0, 5):
        np.testing.assert_allclose(
            TL.positional_encoding(e_t, off, 50).numpy(),
            np.asarray(JL.positional_encoding(e_j, off, 50)), **TOL)
    rows = np.array([0, 4, 11], np.int64)
    np.testing.assert_allclose(
        TL.positional_encoding(e_t[:, :1], torch.from_numpy(rows), 50).numpy(),
        np.asarray(JL.positional_encoding(e_j[:, :1], jnp.asarray(rows), 50)), **TOL)


def test_quantize_probs_and_heads():
    rng = _rng(2)
    p = rng.uniform(0, 1, (2, 4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(TL.quantize_probs(torch.from_numpy(p)).numpy(),
                                  np.asarray(JL.quantize_probs(jnp.asarray(p))))
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    s_t = TL.split_heads(torch.from_numpy(x), 4)
    s_j = JL.split_heads(jnp.asarray(x), 4)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(TL.merge_heads(s_t).numpy(), np.asarray(JL.merge_heads(s_j)))


@pytest.mark.parametrize("quantize", [False, True])
def test_attention(quantize):
    rng = _rng(3)
    q, k, v = (rng.normal(size=(2, 4, 6, 8)).astype(np.float32) for _ in range(3))
    src = rng.integers(4, 30, (2, 6)).astype(np.int64)
    src[1, -2:] = 2
    m_t = TL.make_src_mask(torch.from_numpy(src))[:, None]
    m_j = JL.make_src_mask(jnp.asarray(src))[:, None]
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    scores = rng.normal(size=(2, 4, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(
        TL.attention_probs(torch.from_numpy(scores), m_t, quantize).numpy(),
        np.asarray(JL.attention_probs(jnp.asarray(scores), m_j, quantize)), **TOL)
    got = TL.scaled_dot_attention(*map(torch.from_numpy, (q, k, v)), m_t, quantize)
    want = JL.scaled_dot_attention(*map(jnp.asarray, (q, k, v)), m_j, quantize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masks_and_log_softmax():
    np.testing.assert_array_equal(TL.subsequent_mask(7).numpy(), JL.subsequent_mask(7))
    x = _rng(4).normal(size=(3, 31)).astype(np.float32) * 4
    np.testing.assert_allclose(TL.log_softmax(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.log_softmax(jnp.asarray(x))), **TOL)
    assert TL.NEG_INF == JL.NEG_INF == -1e9


def test_make_tgt_mask():
    tgt = np.array([[0, 5, 6, 2, 2], [0, 7, 1, 4, 3]], np.int32)
    for pad in (2, -1):
        got = TL.make_tgt_mask(torch.from_numpy(tgt), pad=pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(JL.make_tgt_mask(jnp.asarray(tgt),
                                                                               pad=pad)))


def _int8_cache(b=5, t=11, d=32, h=4, seed=7):
    """A query step on the per-token int8 grid and an int8 cache whose later
    positions are masked per row."""
    rng = _rng(seed)
    qi = rng.integers(-127, 128, (b, 1, d)).astype(np.float32)
    q_full = (qi * rng.uniform(0.001, 0.05, (b, 1, 1))).astype(np.float32)
    kq = rng.integers(-127, 128, (b, t, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, t, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (b, t, 1)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (b, t, 1)).astype(np.float32)
    lens = rng.integers(1, t + 1, b)
    mask = (np.arange(t)[None, :] < lens[:, None])[:, None, None, :]
    return q_full, kq, ks, vq, vs, mask


@pytest.mark.parametrize("quantize", [True, False])
def test_int8_cache_attentions(quantize):
    """The scale-after-dot form, the all-int8-operand form and its
    time-major twin, each against its JAX function."""
    args = _int8_cache()
    q_full, kq, ks, vq, vs, mask = args
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    jq = JL.split_heads(jargs[0], 4)
    want = JL.int8_cache_attention(jq, *jargs[1:], quantize)
    got = TL.int8_cache_attention(TL.split_heads(targs[0], 4), *targs[1:], quantize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = JL.int8_cache_attention_qdot(*jargs, quantize, 4)
    got = TL.int8_cache_attention_qdot(*targs, quantize, 4)
    assert got.shape == (5, 1, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tm = [np.ascontiguousarray(a.transpose(1, 0, 2)) for a in (kq, ks, vq, vs)]
    want = JL.int8_cache_attention_qdot_tm(jargs[0], *map(jnp.asarray, tm), jargs[-1],
                                           quantize, 4)
    got_tm = TL.int8_cache_attention_qdot_tm(targs[0], *map(torch.from_numpy, tm), targs[-1],
                                             quantize, 4)
    np.testing.assert_allclose(got_tm.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got_tm, got)
