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
