"""Port of models/stacked_decode.py against the JAX package on the small
config of tests/test_stacked_decode.py: the chunk-staged greedy decode in
"int8" mode gives identical tokens; "fused" mode (kernel plain versions on
the CPU) keeps the encoder memory within atol 1e-4 / rtol 1e-5 and >= 95 %
of the tokens, as tests/test_stacked_decode.py:84-107 requires of its own
kernel path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_transformer_tpu.quant.w8a8 as JW
from onnx_transformer_tpu.models import stacked_decode as JSD
from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import stacked_decode as TSD
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.quant import w8a8 as TW

DIMS = dict(num_layers=3, d_model=32, d_ff=64, num_heads=4)
MAX_LEN = 12


@pytest.fixture(scope="module")
def setup():
    m = Transformer(TransformerConfig(src_vocab_size=37, tgt_vocab_size=31, **DIMS))
    params = m.init(jax.random.key(7))
    sp, lin8 = JW.quantize_transformer(m, params, mode="int8")
    stacked = JSD.build_stacked(m, sp, lin8.payloads)
    pm = PT.Transformer(PT.TransformerConfig(37, 31, **DIMS))
    psp, plin8 = TW.quantize_transformer(pm, params_from_jax(params, device="cpu"), mode="int8")
    pstacked = TSD.build_stacked(pm, psp, plin8.payloads)
    rng = np.random.default_rng(5)
    src = rng.integers(4, 37, (6, 9)).astype(np.int32)
    src[1, -3:] = 2
    src[4, -1:] = 2
    return {"jax": (m, sp, lin8, stacked), "torch": (pm, psp, plin8, pstacked), "src": src,
            "ys": {}}


def _jax_tokens(setup, chunk):
    if chunk not in setup["ys"]:
        m, sp, lin8, stacked = setup["jax"]
        src = jnp.asarray(setup["src"])
        setup["ys"][chunk] = np.array(JSD.greedy_decode_chunked(
            m, sp, stacked, src, JL.make_src_mask(src), MAX_LEN, chunk=chunk, lin=lin8))
    return setup["ys"][chunk]


def _torch_tokens(setup, chunk, lin=None, **kw):
    pm, psp, plin8, pstacked = setup["torch"]
    src = torch.from_numpy(setup["src"])
    return TSD.greedy_decode_chunked(pm, psp, pstacked, src, TL.make_src_mask(src), MAX_LEN,
                                     chunk=chunk, lin=lin or plin8, **kw)


@pytest.mark.parametrize("chunk", [2, 4])
def test_greedy_chunked_tokens_identical(setup, chunk):
    ys = _torch_tokens(setup, chunk)
    assert ys.dtype == torch.int32 and ys.shape == (6, MAX_LEN)
    np.testing.assert_array_equal(ys.numpy(), _jax_tokens(setup, chunk))


def test_chunk_sizes_and_eos_stop_agree(setup):
    """Every chunk size gives the same tokens; without the EOS stop the
    tokens up to each row's first EOS are the same."""
    a = _torch_tokens(setup, 2).numpy()
    for chunk in (1, 3, 6, 12):
        np.testing.assert_array_equal(_torch_tokens(setup, chunk).numpy(), a)
    b = _torch_tokens(setup, 4, stop_at_eos=False).numpy()
    for row_a, row_b in zip(a, b):
        eos = np.flatnonzero(row_b == 1)
        end = eos[0] + 1 if len(eos) else MAX_LEN
        np.testing.assert_array_equal(row_a[:end], row_b[:end])
    with pytest.raises(ValueError):
        _torch_tokens(setup, 5)


def test_fused_mode_matches_int8(setup):
    m, sp, lin8, _ = setup["jax"]
    pm, psp, plin8, _ = setup["torch"]
    old = TW.FUSED_MIN_TOKENS
    TW.FUSED_MIN_TOKENS = 1   # force the kernel path at test shapes
    try:
        linf = TW.make_w8a8_linear_impl(plin8.payloads, mode="fused")
        src = setup["src"]
        tsrc = torch.from_numpy(src)
        mem_f = pm.encode(psp, tsrc, TL.make_src_mask(tsrc), lin=linf)
        assert linf.linear_q8("decoder.layers.0.src_attn.linears.1", mem_f) is not None
        ys_f = _torch_tokens(setup, 4, lin=linf).numpy()
    finally:
        TW.FUSED_MIN_TOKENS = old
    mem_j = m.encode(sp, jnp.asarray(src), JL.make_src_mask(jnp.asarray(src)), lin=lin8)
    np.testing.assert_allclose(mem_f.numpy(), np.asarray(mem_j), atol=1e-4, rtol=1e-5)
    agree = np.mean(ys_f == _jax_tokens(setup, 4))
    assert agree >= 0.95, f"token agreement {agree}"


def test_build_stacked_matches_jax(setup):
    _, _, _, stacked = setup["jax"]
    _, _, _, pst = setup["torch"]
    for i, lp in enumerate(pst["layers"]):
        for role in ("self_qkv", "self_o", "src_q", "src_o", "ffn1", "ffn2"):
            for key in ("wq", "sw", "b"):
                np.testing.assert_array_equal(lp[role][key].numpy(),
                                              np.asarray(stacked["layers"][role][key][i]))
        assert lp["self_qkv"]["wq"].shape == (32, 96)
    np.testing.assert_array_equal(pst["tgt_lut"].numpy(), np.asarray(stacked["tgt_lut"]))
    np.testing.assert_array_equal(pst["generator"]["w"].numpy(),
                                  np.asarray(stacked["generator"]["w"]))


@pytest.mark.parametrize("quantize", [False, True])
def test_attn_groups_matches_jax(quantize):
    """Joint softmax over a cache group and an in-flight group; heads are
    split by a reshape in the port and by a block-diagonal mask in JAX."""
    rng = np.random.default_rng(11)
    b, d, h = 5, 32, 4
    qi = rng.integers(-127, 128, (b, d)).astype(np.int8)
    sq = rng.uniform(0.001, 0.02, b).astype(np.float32)
    groups = []
    for tg in (7, 3):
        vis = rng.uniform(size=(b, tg)) < 0.7
        vis[:, 0] = True
        groups.append({"k": rng.integers(-127, 128, (b, tg, d)).astype(np.int8),
                       "ks": rng.uniform(0.001, 0.02, (b, tg)).astype(np.float32),
                       "v": rng.integers(-127, 128, (b, tg, d)).astype(np.int8),
                       "vs": rng.uniform(0.001, 0.02, (b, tg)).astype(np.float32),
                       "vis": vis})
    want = JSD._attn_groups(jnp.asarray(qi), jnp.asarray(sq),
                            [{k: jnp.asarray(v) for k, v in g.items()} for g in groups],
                            h, quantize)
    got = TSD._attn_groups(torch.from_numpy(qi), torch.from_numpy(sq),
                           [{k: torch.from_numpy(v) for k, v in g.items()} for g in groups],
                           h, quantize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
