"""Port of quant/w8a8.py and quant/smoothquant.py against the JAX package:
payloads bit-equal, smoothed parameters within rtol 1e-6, the int8 chain
bit-equal, and the fused mode (kernel plain versions on the CPU) within
atol 1e-4 / rtol 1e-5 with FUSED_MIN_TOKENS set to 1 in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_transformer_tpu.quant.w8a8 as JW
from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.quant import smoothquant as JS
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.quant import smoothquant as TS
from onnx_transformer_tpu_torch.quant import w8a8 as TW

DIMS = dict(num_layers=3, d_model=32, d_ff=64, num_heads=4)


@pytest.fixture(scope="module")
def setup():
    m = Transformer(TransformerConfig(src_vocab_size=37, tgt_vocab_size=31, **DIMS))
    params = m.init(jax.random.key(7))
    pm = PT.Transformer(PT.TransformerConfig(37, 31, **DIMS))
    return m, params, pm, params_from_jax(params, device="cpu")


@pytest.fixture
def fused_everywhere():
    old = (JW.FUSED_MIN_TOKENS, TW.FUSED_MIN_TOKENS)
    JW.FUSED_MIN_TOKENS = TW.FUSED_MIN_TOKENS = 1
    try:
        yield
    finally:
        JW.FUSED_MIN_TOKENS, TW.FUSED_MIN_TOKENS = old


def _act_scales(n_layers, d, seed=0):
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(n_layers):
        keys += [f"encoder.layers.{i}.self_attn.linears.0", f"encoder.layers.{i}.feed_forward.w_1",
                 f"decoder.layers.{i}.self_attn.linears.0", f"decoder.layers.{i}.src_attn.linears.0",
                 f"decoder.layers.{i}.feed_forward.w_1"]
    return {k: rng.uniform(0.05, 8.0, d).astype(np.float32) for k in keys}


@pytest.mark.parametrize("include_generator", [False, True])
def test_payloads_bit_equal(setup, include_generator):
    m, params, pm, pp = setup
    pj = JW.quantize_model_params(m, params, include_generator=include_generator)
    pt = TW.quantize_model_params(pm, pp, include_generator=include_generator)
    assert set(pj) == set(pt)
    assert ("generator.proj" in pt) == include_generator
    for name in pj:
        for key in ("wq", "sw", "b"):
            np.testing.assert_array_equal(pt[name][key].numpy(), np.asarray(pj[name][key]))
    assert all(TW.is_quantized_output(n) == JW.is_quantized_output(n) for n in pj)
    assert TW.quantized_linear_names(3) == JW.quantized_linear_names(3)


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_smooth_params_matches_jax(setup, alpha):
    m, params, pm, pp = setup
    scales = _act_scales(3, 32)
    sj = JS.smooth_params(params, scales, alpha)
    st = TS.smooth_params(pp, scales, alpha)
    lj = jax.tree_util.tree_flatten_with_path(sj)[0]
    lt = jax.tree_util.tree_leaves(st)
    assert len(lj) == len(lt)
    for (path, a), b in zip(lj, lt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0,
                                   err_msg=jax.tree_util.keystr(path))
    # the input tree is left as it was
    for a, b in zip(jax.tree_util.tree_leaves(pp), jax.tree_util.tree_leaves(params_from_jax(params, "cpu"))):
        assert torch.equal(a, b)
    # only the cross-attention q is migrated
    src_attn = st["decoder"]["layers"][0]["src_attn"]
    assert torch.equal(src_attn["k"]["w"], pp["decoder"]["layers"][0]["src_attn"]["k"]["w"])
    assert not torch.equal(src_attn["q"]["w"], pp["decoder"]["layers"][0]["src_attn"]["q"]["w"])


def test_reference_scales_artifact():
    a = TS.load_reference_scales()
    b = JS.load_reference_scales(TS.SCALES_PATH)
    assert len(a) == 96 and set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["encoder.layers.0.self_attn.linears.1",
                                  "encoder.layers.1.feed_forward.w_1",
                                  "decoder.layers.2.src_attn.linears.3"])
def test_int8_linear_bit_equal(setup, name):
    m, params, pm, pp = setup
    lin_j = JW.make_w8a8_linear_impl(JW.quantize_model_params(m, params), mode="int8")
    lin_t = TW.make_w8a8_linear_impl(TW.quantize_model_params(pm, pp), mode="int8")
    x = np.random.default_rng(1).normal(size=(4, 7, 32 if "w_2" not in name else 64))
    x = x.astype(np.float32)
    want = lin_j(name, jnp.asarray(x), None, None)
    got = lin_t(name, torch.from_numpy(x), None, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lin_t.quantized_output_grid and lin_t.mode == "int8"
    assert not hasattr(lin_t, "linear_q8")


def test_fused_linear_and_q8_match_jax(setup, fused_everywhere):
    m, params, pm, pp = setup
    lin_j = JW.make_w8a8_linear_impl(JW.quantize_model_params(m, params), mode="fused")
    lin_t = TW.make_w8a8_linear_impl(TW.quantize_model_params(pm, pp), mode="fused")
    x = np.random.default_rng(2).normal(size=(4, 7, 32)).astype(np.float32)
    for name in ("encoder.layers.0.self_attn.linears.0", "encoder.layers.2.feed_forward.w_1"):
        want = lin_j(name, jnp.asarray(x), None, None)
        got = lin_t(name, torch.from_numpy(x), None, None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    name = "decoder.layers.1.src_attn.linears.2"
    qj, sj = lin_j.linear_q8(name, jnp.asarray(x))
    qt, st = lin_t.linear_q8(name, torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    # the producer declines what the kernel does not take
    assert lin_t.linear_q8("decoder.layers.1.src_attn.linears.3", torch.from_numpy(x)) is None


def test_fused_gate_uses_token_count(setup):
    m, params, pm, pp = setup
    lin_t = TW.make_w8a8_linear_impl(TW.quantize_model_params(pm, pp), mode="fused")
    x = torch.zeros(4, 7, 32)
    assert TW.FUSED_MIN_TOKENS == JW.FUSED_MIN_TOKENS == 8192
    assert lin_t.linear_q8("decoder.layers.0.src_attn.linears.1", x) is None
    for mode in ("fake", "pallas"):
        with pytest.raises(ValueError):
            TW.make_w8a8_linear_impl({}, mode=mode)
