"""Port of models/stacked_decode.py against the JAX package on the small
config of tests/test_stacked_decode.py: the chunk-staged greedy decode in
"int8" mode gives identical tokens; "fused" mode (kernel plain versions on
the CPU) keeps the encoder memory within atol 1e-4 / rtol 1e-5 and >= 95 %
of the tokens, as tests/test_stacked_decode.py:84-107 requires of its own
kernel path.  The reference's signatures hold positionally:
``start_symbol`` after ``chunk``, ``segments``, ``vis_stg`` and
``log_probs``."""

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


def test_start_symbol_positional(setup):
    """``(..., max_len, chunk, start_symbol, lin)`` as the JAX package takes
    them: column 0 is the start symbol and every token equals JAX's."""
    m, sp, lin8, stacked = setup["jax"]
    pm, psp, plin8, pstacked = setup["torch"]
    src = setup["src"]
    sj, stt = jnp.asarray(src), torch.from_numpy(src)
    want = np.array(JSD.greedy_decode_chunked(m, sp, stacked, sj, JL.make_src_mask(sj),
                                              MAX_LEN, 4, 3, lin8))
    got = TSD.greedy_decode_chunked(pm, psp, pstacked, stt, TL.make_src_mask(stt), MAX_LEN,
                                    4, 3, plin8).numpy()
    assert (got[:, 0] == 3).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("segments", [2, 3, 9])
def test_segments_match_jax_and_one_segment(setup, segments):
    """The self-K/V cache grown at segment boundaries gives the same tokens
    as JAX's and as one segment (9 is cut to the 6 chunks there are)."""
    m, sp, lin8, stacked = setup["jax"]
    src = jnp.asarray(setup["src"])
    got = _torch_tokens(setup, 2, segments=segments).numpy()
    np.testing.assert_array_equal(got, _torch_tokens(setup, 2).numpy())
    if segments != 9:
        want = np.array(JSD.greedy_decode_chunked(m, sp, stacked, src, JL.make_src_mask(src),
                                                  MAX_LEN, chunk=2, lin=lin8,
                                                  segments=segments))
        np.testing.assert_array_equal(got, want)


def _step_state(d, t, s, j, seed, n_layers):
    """A main int8 cache of T rows, a cross cache of S rows, j staged rows
    per layer, and an embedded token, for B=5."""
    rng = np.random.default_rng(seed)
    b = 5

    def i8(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def sc(*shape):
        return rng.uniform(0.001, 0.02, shape).astype(np.float32)

    cache = [{"k": i8(b, t, d), "v": i8(b, t, d), "k_scale": sc(b, t, 1), "v_scale": sc(b, t, 1),
              "cross_k": i8(b, s, d), "cross_v": i8(b, s, d), "cross_k_scale": sc(b, s, 1),
              "cross_v_scale": sc(b, s, 1)} for _ in range(n_layers)]
    inflight = [{"k": i8(b, j, d), "v": i8(b, j, d), "ks": sc(b, j), "vs": sc(b, j)}
                for _ in range(n_layers)]
    x = rng.normal(size=(b, d)).astype(np.float32)
    vis_cache = np.arange(t)[None, :] < rng.integers(1, t, (b, 1))
    vis_stg = rng.uniform(size=(b, j + 1)) < 0.5
    vis_stg[:, -1] = True           # a row always sees itself
    smask = np.ones((b, s), bool)
    smask[1, -2:] = False
    return cache, inflight, x, vis_cache, vis_stg, smask


def test_layer_stack_step_vis_stg_matches_jax(setup):
    """Per-row visibility of the staged rows, as the engine passes it: x
    and the in-flight rows equal JAX's, and hiding rows changes x."""
    m, _, _, stacked = setup["jax"]
    _, _, _, pstacked = setup["torch"]
    cfg = m.cfg
    cache, inflight, x, vis_cache, vis_stg, smask = _step_state(cfg.d_model, 8, 9, 3, 4,
                                                                cfg.num_layers)
    h, quant = cfg.num_heads, cfg.quantize_attn_probs
    to_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)   # noqa: E731
    to_t = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)   # noqa: E731
    xj, flj = JSD.layer_stack_step_inflight(stacked, to_j(cache), to_j(inflight), jnp.asarray(x),
                                            jnp.asarray(vis_cache), jnp.asarray(vis_stg),
                                            jnp.asarray(smask), h, quant)
    xt, flt = TSD.layer_stack_step_inflight(pstacked, to_t(cache), to_t(inflight),
                                            torch.from_numpy(x), torch.from_numpy(vis_cache),
                                            torch.from_numpy(vis_stg), torch.from_numpy(smask),
                                            h, quant)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5, rtol=1e-5)
    # the int8 rows are equal in every layer; the new rows' scales agree
    # within rtol 1e-6, since each layer's input went through f32 LayerNorm
    # and attention sums that XLA and PyTorch order differently
    for lj, lt in zip(flj, flt):
        assert lt["k"].shape[1] == 4
        for key in ("k", "v"):
            np.testing.assert_array_equal(lt[key].numpy(), np.asarray(lj[key]))
        for key in ("ks", "vs"):
            np.testing.assert_array_equal(lt[key][:, :3].numpy(), np.asarray(lj[key])[:, :3])
            np.testing.assert_allclose(lt[key].numpy(), np.asarray(lj[key]), atol=0, rtol=1e-6)
    x_all, _ = TSD.layer_stack_step_inflight(pstacked, to_t(cache), to_t(inflight),
                                             torch.from_numpy(x), torch.from_numpy(vis_cache),
                                             None, torch.from_numpy(smask), h, quant)
    x_ones, _ = TSD.layer_stack_step_inflight(pstacked, to_t(cache), to_t(inflight),
                                              torch.from_numpy(x), torch.from_numpy(vis_cache),
                                              torch.ones(5, 4, dtype=torch.bool),
                                              torch.from_numpy(smask), h, quant)
    assert torch.equal(x_all, x_ones) and not torch.equal(x_all, xt)


def test_final_logits_log_probs_matches_jax(setup):
    _, _, _, stacked = setup["jax"]
    _, _, _, pstacked = setup["torch"]
    x = np.random.default_rng(12).normal(size=(5, 32)).astype(np.float32)
    for log_probs in (False, True):
        want = np.asarray(JSD.final_logits(stacked, jnp.asarray(x), log_probs))
        got = TSD.final_logits(pstacked, torch.from_numpy(x), log_probs).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    lp = TSD.final_logits(pstacked, torch.from_numpy(x), log_probs=True)
    np.testing.assert_allclose(lp.exp().sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("pos", [0, 5, [0, 3, 0, 11, 7, 1]])
def test_embed_token_matches_jax(setup, pos):
    """A position for the whole batch, or a [B] vector of per-row positions
    (with position 0 among them), as the serving engine's fast chunk embeds
    each slot at its own position."""
    m, _, _, stacked = setup["jax"]
    pm, _, _, pstacked = setup["torch"]
    tok = np.random.default_rng(8).integers(0, 31, (6, 1)).astype(np.int32)
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    want = np.asarray(JSD.embed_token(stacked, m.cfg, jnp.asarray(tok), jpos))
    got = TSD.embed_token(pstacked, pm.cfg, torch.from_numpy(tok), tpos)
    assert got.shape == (6, 32)
    np.testing.assert_array_equal(got.numpy(), want)
