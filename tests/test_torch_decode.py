"""Port of serving/decode.py against the JAX package.

- greedy_decode gives the JAX package's token ids exactly on the small
  config of tests/test_pallas_kernels.py:121-140: fp32 cache; int8 cache
  under the fp32 model (the scale-after-dot attention) and under W8A8 mode
  int8 (the all-int8-operand attention); int8 cache with fused_attn=True (K3's plain version
  here, the interpreted Pallas kernel in JAX) under modes int8 and pallas
  (K5's plain version, the interpreted Pallas kernel).
- The decode relations of tests/test_decode.py:33-155 hold in the port:
  no-cache parity, the EOS stop, early exit, beam size 1, ids_to_tokens,
  time-major = batch-major, the int8 cache lossless under W8A8.
- beam_decode gives JAX's tokens (ties broken as jax.lax.top_k breaks
  them); the chunk-staged decode equals greedy_decode with the int8 cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu.serving import decode as JD
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import stacked_decode as TSD
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.ops.kernels import decode_attention as KA
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving import decode as TD


def _models(src_vocab, tgt_vocab, seed, **dims):
    m = Transformer(TransformerConfig(src_vocab, tgt_vocab, dropout=0.0, **dims))
    params = m.init(jax.random.key(seed))
    pm = PT.Transformer(PT.TransformerConfig(src_vocab, tgt_vocab, **dims))
    return m, params, pm, params_from_jax(params, device="cpu")


@pytest.fixture(scope="module")
def kernel_cfg():
    """tests/test_pallas_kernels.py:129-135."""
    m, params, pm, pp = _models(97, 89, 0, num_layers=2, d_model=64, d_ff=128, num_heads=4)
    src = np.random.default_rng(1).integers(3, 90, (4, 9)).astype(np.int32)
    return m, params, pm, pp, src


@pytest.fixture(scope="module")
def small():
    """tests/test_decode.py:14-29."""
    m, params, pm, pp = _models(31, 29, 3, num_layers=2, d_model=32, d_ff=64, num_heads=4)
    src = np.random.default_rng(1).integers(4, 31, (4, 9)).astype(np.int32)
    src[1, -3:] = 2
    return m, params, pm, pp, src


def _masks(src):
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    return jsrc, JL.make_src_mask(jsrc), tsrc, TL.make_src_mask(tsrc)


@pytest.mark.parametrize("mode,kv,fused", [(None, "fp32", False), (None, "int8", False),
                                           ("int8", "int8", False), ("int8", "int8", True),
                                           ("pallas", "int8", True)])
def test_greedy_tokens_identical_to_jax(kernel_cfg, mode, kv, fused):
    m, params, pm, pp, src = kernel_cfg
    jsrc, jmask, tsrc, tmask = _masks(src)
    jkw, lin = {}, PT.default_linear
    if mode:
        _, jkw["lin"] = JW.quantize_transformer(m, params, mode=mode)
        _, lin = TW.quantize_transformer(pm, pp, mode=mode)
    want = np.asarray(JD.greedy_decode(m, params, jsrc, jmask, 12, kv_cache_dtype=kv,
                                       fused_attn=fused, **jkw))
    counts = (KA.decode_attention_int8.launches, KM.w8a8_matmul.launches)
    got = TD.greedy_decode(pm, pp, tsrc, tmask, 12, lin=lin, kv_cache_dtype=kv,
                           fused_attn=fused)
    assert got.dtype == torch.int32 and got.shape == (4, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU the wrappers take their plain versions and count nothing
    assert (KA.decode_attention_int8.launches, KM.w8a8_matmul.launches) == counts


def test_nocache_parity_and_jax(small):
    """The no-cache oracle equals the cached decode without the EOS stop,
    and both give the JAX cached decode's tokens (the JAX no-cache oracle
    runs eagerly and takes half a minute: its own test is in the slow tier)."""
    m, params, pm, pp, src = small
    jsrc, jmask, tsrc, tmask = _masks(src)
    nc = TD.greedy_decode_nocache(pm, pp, tsrc, tmask, 12)
    cached = TD.greedy_decode(pm, pp, tsrc, tmask, 12, stop_at_eos=False)
    assert torch.equal(cached, nc)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(JD.greedy_decode(
        m, params, jsrc, jmask, 12, stop_at_eos=False)))


def test_eos_stop_pads_after_eos(small):
    m, params, pm, pp, src = small
    _, _, tsrc, tmask = _masks(src)
    ys = TD.greedy_decode(pm, pp, tsrc, tmask, 14, stop_at_eos=True).numpy()
    for row in ys:
        eos = np.flatnonzero(row[1:] == pm.cfg.eos_id)
        if len(eos):
            assert (row[2 + eos[0]:] == pm.cfg.pad_id).all()


@pytest.mark.parametrize("kv,fused", [("fp32", False), ("int8", True)])
def test_early_exit_matches_greedy(small, kv, fused):
    m, params, pm, pp, src = small
    _, _, tsrc, tmask = _masks(src)
    _, lin = TW.quantize_transformer(pm, pp, mode="int8")
    a = TD.greedy_decode(pm, pp, tsrc, tmask, 12, lin=lin, kv_cache_dtype=kv, fused_attn=fused)
    b = TD.greedy_decode_early_exit(pm, pp, tsrc, tmask, 12, lin=lin, kv_cache_dtype=kv,
                                    fused_attn=fused)
    assert torch.equal(a, b)


def test_beam_size_1_equals_greedy(small):
    m, params, pm, pp, src = small
    _, _, tsrc, tmask = _masks(src)
    assert torch.equal(TD.beam_decode(pm, pp, tsrc, tmask, 10, beam_size=1),
                       TD.greedy_decode(pm, pp, tsrc, tmask, 10))


@pytest.mark.parametrize("beam,kv", [(4, "fp32"), (2, "int8")])
def test_beam_tokens_identical_to_jax(small, beam, kv):
    m, params, pm, pp, src = small
    jsrc, jmask, tsrc, tmask = _masks(src)
    want = np.asarray(JD.beam_decode(m, params, jsrc, jmask, 8, beam_size=beam,
                                     kv_cache_dtype=kv))
    got = TD.beam_decode(pm, pp, tsrc, tmask, 8, beam_size=beam, kv_cache_dtype=kv)
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_breaks_ties_like_jax():
    x = np.array([[0.0, 3.0, -1e9, 3.0, -1e9, -1e9, 3.0]], np.float32)
    vals, idx = TD._top_k_stable(torch.from_numpy(x), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_ids_to_tokens_cuts_at_eos():
    class V:
        itos = ["<s>", "</s>", "<blank>", "<unk>", "a", "b"]

    ids = np.array([[0, 4, 5, 1, 4], [0, 5, 2, 5, 1]])
    assert TD.ids_to_tokens(ids, V()) == [["a", "b"], ["b", "b"]]
    assert TD.ids_to_tokens(torch.from_numpy(ids), V()) == [["a", "b"], ["b", "b"]]


def test_int8_cache_lossless_and_time_major(small):
    """Under W8A8 the int8 cache gives the fp32 cache's tokens, and the
    time-major int8 cache the batch-major one's."""
    m, params, pm, pp, src = small
    _, _, tsrc, tmask = _masks(src)
    _, lin = TW.quantize_transformer(pm, pp, mode="int8")
    fp = TD.greedy_decode(pm, pp, tsrc, tmask, 12, lin=lin)
    i8 = TD.greedy_decode(pm, pp, tsrc, tmask, 12, lin=lin, kv_cache_dtype="int8")
    tm = TD.greedy_decode(pm, pp, tsrc, tmask, 12, lin=lin, kv_cache_dtype="int8",
                          kv_time_major=True)
    assert torch.equal(fp, i8) and torch.equal(i8, tm)


def test_chunked_decode_equals_greedy_int8(small):
    """The chunk-staged fast path and the KV-cached decode with the int8
    cache give the same tokens (tests/test_stacked_decode.py:39-50)."""
    m, params, pm, pp, src = small
    _, _, tsrc, tmask = _masks(src)
    sp, lin = TW.quantize_transformer(pm, pp, mode="int8")
    stacked = TSD.build_stacked(pm, sp, lin.payloads)
    want = TD.greedy_decode(pm, sp, tsrc, tmask, 12, lin=lin, kv_cache_dtype="int8")
    for chunk in (3, 4):
        got = TSD.greedy_decode_chunked(pm, sp, stacked, tsrc, tmask, 12, chunk=chunk, lin=lin)
        assert torch.equal(got, want)


def test_numpy_src_goes_to_the_card():
    """A source that is not a tensor is placed on the card; without one
    that is an error, never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the numpy source would go to it")
    pm = PT.Transformer(PT.TransformerConfig(31, 29, num_layers=1, d_model=32, d_ff=64,
                                             num_heads=4))
    src = np.full((2, 5), 4, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.greedy_decode(pm, pm.init(seed=0, device="cpu"), src, src[:, None, :] != 2, 4)
