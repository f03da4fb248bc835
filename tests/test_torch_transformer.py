"""Port of models/transformer.py (encode, cross_kv) against the JAX package
on the small config of tests/test_stacked_decode.py, with the JAX
parameters converted by params_from_jax.  f32 within atol 1e-4 / rtol 1e-5
(tests/test_stacked_decode.py:99); int8 cache rows bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.quant import w8a8 as TW

TOL = dict(atol=1e-4, rtol=1e-5)
DIMS = dict(num_layers=3, d_model=32, d_ff=64, num_heads=4)


@pytest.fixture(scope="module")
def setup():
    m = Transformer(TransformerConfig(src_vocab_size=37, tgt_vocab_size=31, **DIMS))
    params = m.init(jax.random.key(7))
    pm = PT.Transformer(PT.TransformerConfig(37, 31, **DIMS))
    rng = np.random.default_rng(5)
    src = rng.integers(4, 37, (6, 9)).astype(np.int32)
    src[1, -3:] = 2
    src[4, -1:] = 2
    return m, params, pm, params_from_jax(params, device="cpu"), src


def _linears(m, params, pm, pp, mode):
    if mode == "fp32":
        return params, None, pp, PT.default_linear
    sp, lin = JW.quantize_transformer(m, params, mode="int8")
    psp, plin = TW.quantize_transformer(pm, pp, mode="int8")
    return sp, lin, psp, plin


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_encode_matches_jax(setup, mode):
    m, params, pm, pp, src = setup
    sp, lin, psp, plin = _linears(m, params, pm, pp, mode)
    sm = JL.make_src_mask(jnp.asarray(src))
    want = m.encode(sp, jnp.asarray(src), sm, **({"lin": lin} if lin else {}))
    tsrc = torch.from_numpy(src)
    got = pm.encode(psp, tsrc, TL.make_src_mask(tsrc), lin=plin)
    assert got.shape == (6, 9, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_cross_kv_matches_jax(setup, mode):
    m, params, pm, pp, src = setup
    sp, lin, psp, plin = _linears(m, params, pm, pp, mode)
    mem = np.random.default_rng(9).normal(size=(6, 9, 32)).astype(np.float32)
    cache = "int8" if mode == "int8" else "fp32"
    kw = {"lin": lin} if lin else {}
    want = m.cross_kv(sp, jnp.asarray(mem), cache_dtype=cache, **kw)
    got = pm.cross_kv(psp, torch.from_numpy(mem), lin=plin, cache_dtype=cache)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if mode == "int8":
                np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
            else:
                assert g[key].shape == (6, 4, 9, 8)
                np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), **TOL)


def test_init_structure_and_seed():
    jp = Transformer(TransformerConfig(src_vocab_size=37, tgt_vocab_size=31, **DIMS)).init(
        jax.random.key(0))
    pm = PT.Transformer(PT.TransformerConfig(37, 31, **DIMS))
    a = pm.init(seed=3, device="cpu")
    b = pm.init(seed=3, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    leaves_a = jax.tree_util.tree_leaves(a)
    assert len(flat_j) == len(leaves_a) == len(jax.tree_util.tree_leaves(b))
    shapes_j = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in flat_j}
    shapes_a = {jax.tree_util.keystr(p): tuple(x.shape)
                for p, x in jax.tree_util.tree_flatten_with_path(a)[0]}
    assert shapes_a == shapes_j
    for x, y in zip(leaves_a, jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)
    w = a["encoder"]["layers"][0]["self_attn"]["q"]["w"]
    assert float(w.abs().max()) <= np.sqrt(6.0 / 64) and float(w.std()) > 0
