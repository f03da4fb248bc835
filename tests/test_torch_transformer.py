"""Port of models/transformer.py (encode, cross_kv, the teacher-forced and
cached decode, init_cache, decode_step, generate) against the JAX package
on the small config of tests/test_stacked_decode.py, with the JAX
parameters converted by params_from_jax.  f32 within atol 1e-4 / rtol 1e-5
(tests/test_stacked_decode.py:99); int8 cache rows bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.models import transformer as JT
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


def _tgt(b=6, t=7, seed=8):
    tgt = np.random.default_rng(seed).integers(3, 31, (b, t)).astype(np.int32)
    tgt[:, 0] = 0
    tgt[2, -2:] = 2
    return tgt


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_decode_teacher_forced_and_logits_match_jax(setup, mode):
    m, params, pm, pp, src = setup
    sp, lin, psp, plin = _linears(m, params, pm, pp, mode)
    kw = {"lin": lin} if lin else {}
    tgt = _tgt()
    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)
    want = m.forward_logits(sp, jsrc, jtgt, JL.make_src_mask(jsrc), JL.make_tgt_mask(jtgt),
                            **kw)
    tsrc, ttgt = torch.from_numpy(src), torch.from_numpy(tgt)
    tmask = TL.make_tgt_mask(ttgt)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(JL.make_tgt_mask(jtgt)))
    got = pm.forward_logits(psp, tsrc, ttgt, TL.make_src_mask(tsrc), tmask, lin=plin)
    assert got.shape == (6, 7, 31)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mem = pm.encode(psp, tsrc, TL.make_src_mask(tsrc), lin=plin)
    h = pm.decode(psp, mem, TL.make_src_mask(tsrc), ttgt, tmask, lin=plin)
    assert torch.equal(pm.generate(psp, h, lin=plin), got)
    assert torch.equal(torch.argmax(pm.generate(psp, h, lin=plin, log_probs=False), -1),
                       torch.argmax(got, -1))


@pytest.mark.parametrize("cache", ["fp32", "int8", "int8_tm"])
def test_init_cache_matches_jax(setup, cache):
    m, params, pm, pp, src = setup
    sp, lin, psp, plin = _linears(m, params, pm, pp, "int8")
    mem = np.random.default_rng(2).normal(size=(6, 9, 32)).astype(np.float32)
    dtype, tm = cache[:4], cache.endswith("tm")
    want = m.init_cache(sp, jnp.asarray(mem), 11, lin=lin, cache_dtype=dtype, time_major=tm)
    got = pm.init_cache(psp, torch.from_numpy(mem), 11, lin=plin, cache_dtype=dtype,
                        time_major=tm)
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for key in w:
            assert tuple(g[key].shape) == w[key].shape, key
            assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype), key
            np.testing.assert_allclose(g[key].numpy().astype(np.float32),
                                       np.asarray(w[key]).astype(np.float32), **TOL)


def _step_indices(kind, i, b=6):
    """(index, ring_index) of step i for a decode_step kind."""
    if kind == "scalar":
        return i, None
    if kind == "vector":
        return np.minimum(np.arange(b) % 3 + i, 10).astype(np.int32), None
    return np.full(b, i, np.int32) - np.arange(b) % 2, (i + 4) % 11


@pytest.mark.parametrize("cache,kind", [("fp32", "scalar"), ("int8", "scalar"),
                                        ("int8", "vector"), ("int8", "ring")])
def test_decode_step_matches_jax(setup, cache, kind):
    """The fp32 cache under the fp32 model, the int8 cache under W8A8 (the
    pairs the decoders use).  W8A8 over the fp32 cache is left out: there a
    one-ulp difference of the float attention's sums can flip one int8
    rounding of the o-projection's input, 2e-3 in one row's log-probs."""
    m, params, pm, pp, src = setup
    sp, lin, psp, plin = _linears(m, params, pm, pp, cache)
    kw = {"lin": lin} if lin else {}
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    jmask, tmask = JL.make_src_mask(jsrc), TL.make_src_mask(tsrc)
    jc = m.init_cache(sp, m.encode(sp, jsrc, jmask, **kw), 11, cache_dtype=cache, **kw)
    tc = pm.init_cache(psp, pm.encode(psp, tsrc, tmask, lin=plin), 11, lin=plin,
                       cache_dtype=cache)
    toks = np.random.default_rng(6).integers(3, 31, (3, 6, 1)).astype(np.int32)
    for i in range(3):
        idx, ring = _step_indices(kind, i)
        jidx = jnp.asarray(idx) if kind != "scalar" else idx
        tidx = torch.from_numpy(idx) if kind != "scalar" else idx
        want, jc = m.decode_step(sp, jc, jnp.asarray(toks[i]), jidx, jmask,
                                 ring_index=ring, **kw)
        got, tc = pm.decode_step(psp, tc, torch.from_numpy(toks[i]), tidx, tmask, lin=plin,
                                 ring_index=ring)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(tc["layers"], jc["layers"]):
        for key in ("k", "v", "k_scale", "v_scale") if cache == "int8" else ("k", "v"):
            np.testing.assert_allclose(g[key].numpy().astype(np.float32),
                                       np.asarray(w[key]).astype(np.float32), **TOL)


def test_decode_step_writes_in_place_and_repeats(setup):
    """The port writes each step's K/V rows into the cache's buffers (the
    JAX version is functional).  Repeating a step at the same index writes
    the same rows again and gives the same log-probs, and the buffers seen
    by the caller hold exactly the rows the JAX cache holds."""
    m, params, pm, pp, src = setup
    sp, lin, psp, plin = _linears(m, params, pm, pp, "int8")
    tsrc = torch.from_numpy(src)
    tmask = TL.make_src_mask(tsrc)
    cache = pm.init_cache(psp, pm.encode(psp, tsrc, tmask, lin=plin), 8, lin=plin,
                          cache_dtype="int8")
    k_buf = cache["layers"][0]["k"]
    tok = torch.full((6, 1), 5, dtype=torch.int32)
    a, c1 = pm.decode_step(psp, cache, tok, 0, tmask, lin=plin)
    assert c1["layers"][0]["k"] is k_buf and bool((k_buf[:, 0] != 0).any())
    row0 = k_buf[:, 0].clone()
    b, c2 = pm.decode_step(psp, c1, tok, 0, tmask, lin=plin)
    assert torch.equal(a, b) and torch.equal(k_buf[:, 0], row0)
    assert not bool(k_buf[:, 1:].any())
    c, _ = pm.decode_step(psp, c2, tok + 1, 1, tmask, lin=plin)
    jsrc = jnp.asarray(src)
    jmask = JL.make_src_mask(jsrc)
    jc = m.init_cache(sp, m.encode(sp, jsrc, jmask, lin=lin), 8, lin=lin, cache_dtype="int8")
    _, jc = m.decode_step(sp, jc, jnp.asarray(tok.numpy()), 0, jmask, lin=lin)
    want, jc = m.decode_step(sp, jc, jnp.asarray(tok.numpy() + 1), 1, jmask, lin=lin)
    np.testing.assert_allclose(c.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(k_buf.numpy(), np.asarray(jc["layers"][0]["k"]))


@pytest.mark.parametrize("idx", [3, -2, 40, [0, 4, 9, -1, 10, 2]])
def test_cache_updates_match_jax(idx):
    """Scalar indices wrap negatives and clamp (dynamic_update_slice); [B]
    indices wrap negatives and drop rows past the end (scatter
    mode="drop")."""
    rng = np.random.default_rng(1)
    buf4 = rng.normal(size=(6, 2, 10, 3)).astype(np.float32)
    new4 = rng.normal(size=(6, 2, 1, 3)).astype(np.float32)
    buf3 = rng.normal(size=(6, 10, 5)).astype(np.float32)
    new3 = rng.normal(size=(6, 1, 5)).astype(np.float32)
    jidx = jnp.asarray(idx, jnp.int32)
    tidx = torch.tensor(idx, dtype=torch.int32) if isinstance(idx, list) else idx
    want4 = np.asarray(JT._cache_update(jnp.asarray(buf4), jnp.asarray(new4), jidx))
    got4 = PT._cache_update(torch.from_numpy(buf4.copy()), torch.from_numpy(new4), tidx)
    np.testing.assert_array_equal(got4.numpy(), want4)
    want3 = np.asarray(JT._scale_update(jnp.asarray(buf3), jnp.asarray(new3), jidx))
    got3 = PT._scale_update(torch.from_numpy(buf3.copy()), torch.from_numpy(new3), tidx)
    np.testing.assert_array_equal(got3.numpy(), want3)
    if not isinstance(idx, list):
        buf_tm = buf3.transpose(1, 0, 2).copy()
        want_tm = np.asarray(JT._scale_update(jnp.asarray(buf_tm), jnp.asarray(new3), jidx,
                                              time_major=True))
        got_tm = PT._scale_update(torch.from_numpy(buf_tm), torch.from_numpy(new3), tidx,
                                  time_major=True)
        np.testing.assert_array_equal(got_tm.numpy(), want_tm)
