"""The port's tap/inject seam, dropout and activation calibration against the
JAX package, at the JAX tests' small configuration (vocabularies 37/31, 2
layers, d_model 32, d_ff 64, 4 heads, weights from ``jax.random.key(21)``
carried across with ``params_from_jax``): the configuration's fields (F5),
``smooth_params(faithful_cross_attn=...)`` (F6), ``absmax_scale``'s keyword
names (F7), the taps of ``forward`` under the fp, W8A8 ``int8`` and ``fake``
linears, an inject dict, the routing around the kernels, and
``get_act_scales``.  f32 within atol 1e-4 / rtol 1e-5, int8 bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.models import transformer as JT
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import calibrate as JC
from onnx_transformer_tpu.quant import core as JQ
from onnx_transformer_tpu.quant import smoothquant as JS
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM
from onnx_transformer_tpu_torch.quant import calibrate as TC
from onnx_transformer_tpu_torch.quant import core as TQ
from onnx_transformer_tpu_torch.quant import int4 as T4
from onnx_transformer_tpu_torch.quant import smoothquant as TS
from onnx_transformer_tpu_torch.quant import w8a8 as TW

TOL = dict(atol=1e-4, rtol=1e-5)
CFG_ARGS = (37, 31, 2, 32, 64, 4, 0.0)


@pytest.fixture(scope="module")
def setup():
    m = JT.Transformer(JT.TransformerConfig(*CFG_ARGS))
    params = m.init(jax.random.key(21))
    pm = PT.Transformer(PT.TransformerConfig(*CFG_ARGS))
    return m, params, pm, params_from_jax(params, device="cpu")


def _batch(seed=5, b=3, s=7, t=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 37, (b, s)).astype(np.int32)
    src[0, -2:] = 2
    tgt = rng.integers(4, 31, (b, t)).astype(np.int32)
    tgt[:, 0] = 0
    sm = np.asarray(JL.make_src_mask(jnp.asarray(src)))
    tm = np.asarray(JL.make_tgt_mask(jnp.asarray(tgt)))
    return src, tgt, sm, tm


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


# --------------------------------------------------------------- F5, F6, F7

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


@pytest.mark.parametrize("args, kw", [
    (CFG_ARGS, {}),
    ((37, 31), {"dropout": 0.1, "scan_layers": True}),
    ((5337, 4444), {"num_layers": 6, "dropout": 0.3, "max_len": 128}),
])
def test_config_fields_match_reference(args, kw):
    """The reference's fields in its order: the seventh positional is
    ``dropout``, ``scan_layers`` is accepted, and ``with_`` replaces."""
    j = JT.TransformerConfig(*args, **kw)
    t = PT.TransformerConfig(*args, **kw)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert _fields(t) == _fields(j)
    assert t.dtype == torch.float32
    assert _fields(t.with_(max_len=64, dropout=0.0)) == _fields(j.with_(max_len=64, dropout=0.0))


def test_scan_layers_gives_the_same_forward(setup):
    m, params, pm, pp = setup
    (_, _, _, _), (src, tgt, sm, tm) = _both(_batch())
    scanned = PT.Transformer(pm.cfg.with_(scan_layers=True))
    assert torch.equal(scanned.forward(pp, src, tgt, sm, tm), pm.forward(pp, src, tgt, sm, tm))


def _random_scales(model_names, seed=7):
    return {name: np.abs(np.random.default_rng(seed).normal(size=64 if name.endswith("w_2")
                                                            else 32)).astype(np.float32) + 0.05
            for name in model_names}


@pytest.mark.parametrize("faithful", [False, True])
def test_smooth_params_faithful_cross_attn_matches_jax(setup, faithful):
    """The same leaves migrate as in the JAX package (with ``faithful`` the
    cross-attention k/v too); the leaves it leaves alone are bit-equal and
    the migrated ones within rtol 1e-6, the bound of
    ``test_torch_w8a8.test_smooth_params_matches_jax`` (``x ** alpha`` is not
    correctly rounded in either library, and JAX's differs between eager
    and jitted code)."""
    m, params, pm, pp = setup
    scales = _random_scales(JC._linear_input_names(m))
    sj = JS.smooth_params(params, scales, faithful_cross_attn=faithful)
    st = TS.smooth_params(pp, scales, faithful_cross_attn=faithful)
    lj = jax.tree_util.tree_flatten_with_path(sj)[0]
    l0 = jax.tree_util.tree_leaves(params)
    lt = jax.tree_util.tree_leaves(st)
    assert len(lj) == len(lt) == len(l0)
    migrated = 0
    for (path, a), b, orig in zip(lj, lt, l0):
        if np.array_equal(np.asarray(a), np.asarray(orig)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=jax.tree_util.keystr(path))
        else:
            migrated += 1
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0,
                                       err_msg=jax.tree_util.keystr(path))
    cross = st["decoder"]["layers"][1]["src_attn"]
    orig = pp["decoder"]["layers"][1]["src_attn"]
    assert torch.equal(cross["k"]["w"], orig["k"]["w"]) != faithful
    assert torch.equal(cross["v"]["w"], orig["v"]["w"]) != faithful
    # migrated leaves per layer (LN scales and fc weights; the LN biases are
    # zero at init): encoder LN0 + q/k/v, LN1 + w1; decoder LN0 + q/k/v,
    # LN1 + q (or q/k/v), LN2 + w1
    assert migrated == 2 * 6 + 2 * (10 if faithful else 8)


@pytest.mark.parametrize("call", [
    lambda Q, w: Q.absmax_scale(w, axis=0, bits=4, keepdims=False),
    lambda Q, w: Q.absmax_scale(w, 0, 4, False),
    lambda Q, w: Q.absmax_scale(w, axis=-1),
    lambda Q, w: Q.absmax_scale(w, -1, 8, True),
])
def test_absmax_scale_reference_keywords(call):
    """The reference's own call ``absmax_scale(w, axis=0, bits=4,
    keepdims=False)`` (``quant/int4.py``) and its positional form."""
    w = np.random.default_rng(1).normal(size=(32, 48)).astype(np.float32)
    want = np.asarray(call(JQ, jnp.asarray(w)))
    got = call(TQ, torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- taps, inject

def _impls(m, params, pm, pp, kind):
    if kind == "fp32":
        return JT.default_linear, PT.default_linear
    pj = JW.quantize_model_params(m, params)
    pt = TW.quantize_model_params(pm, pp)
    return JW.make_w8a8_linear_impl(pj, kind), TW.make_w8a8_linear_impl(pt, kind)


@pytest.mark.parametrize("kind", ["fp32", "int8", "fake"])
def test_forward_taps_match_jax(setup, kind):
    m, params, pm, pp = setup
    (js, jt, jsm, jtm), (ts, tt, tsm, ttm) = _both(_batch())
    lin_j, lin_t = _impls(m, params, pm, pp, kind)
    taps_j, taps_t = {}, {}
    hj = m.forward(params, js, jt, jsm, jtm, taps=taps_j, lin=lin_j)
    ht = pm.forward(pp, ts, tt, tsm, ttm, taps=taps_t, lin=lin_t)
    assert set(taps_t) == set(taps_j)
    kinds = {k.rsplit(".", 1)[-1] for k in taps_t}
    assert {"scores", "probs", "context", "out"} <= kinds
    if kind != "fp32":
        assert {"x_q", "w_q", "out_q"} <= kinds
    for k, vj in taps_j.items():
        vt = taps_t[k].numpy()
        if k.endswith((".x_q", ".w_q")):
            assert vt.dtype == np.int8
            np.testing.assert_array_equal(vt, np.asarray(vj), err_msg=k)
        else:
            np.testing.assert_allclose(vt, np.asarray(vj), err_msg=k, **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_inject_matches_jax(setup, kind):
    """An inject dict that zeroes the first encoder layer's attention
    probabilities and scales a decoder FFN output: the same logits as
    JAX's, and not the clean ones."""
    m, params, pm, pp = setup
    (js, jt, jsm, jtm), (ts, tt, tsm, ttm) = _both(_batch())
    lin_j, lin_t = _impls(m, params, pm, pp, kind)
    inject = {"encoder.layers.0.self_attn.probs": lambda p: p * 0,
              "decoder.layers.1.feed_forward.w_1.out": lambda y: y * 0.5}
    want = m.forward_logits(params, js, jt, jsm, jtm, inject=inject, lin=lin_j)
    got = pm.forward_logits(pp, ts, tt, tsm, ttm, inject=inject, lin=lin_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    clean = pm.forward_logits(pp, ts, tt, tsm, ttm, lin=lin_t)
    assert not torch.allclose(got, clean)


def _raise(*a, **k):
    raise AssertionError("a kernel was called under taps or inject")


@pytest.mark.parametrize("seams", [{"taps": {}}, {"inject": {}}])
def test_fused_linears_route_around_k1_k2(setup, monkeypatch, seams):
    """Mode ``fused`` sends a q/k/v call to K1 and the cross-K/V to K2, but
    not under taps or inject (their seams are not in the kernels)."""
    m, params, pm, pp = setup
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 1)
    monkeypatch.setattr(KM, "quant_w8a8_matmul_qout", _raise)
    monkeypatch.setattr(KM, "quant_w8a8_matmul_q8", _raise)
    _, (ts, tt, tsm, ttm) = _both(_batch())
    lin = TW.make_w8a8_linear_impl(TW.quantize_model_params(pm, pp), "fused")
    with pytest.raises(AssertionError, match="kernel"):
        pm.encode(pp, ts, tsm, lin=lin)
    mem = pm.encode(pp, ts, tsm, lin=lin, **seams)
    want = pm.encode(pp, ts, tsm, lin=TW.make_w8a8_linear_impl(lin.payloads, "int8"))
    assert torch.equal(mem, want)
    with pytest.raises(AssertionError, match="kernel"):
        pm.cross_kv(pp, mem, lin=lin, cache_dtype="int8")
    pm.init_cache(pp, mem, 6, lin=lin, cache_dtype="int8", **seams)


@pytest.mark.parametrize("seams", [{"taps": {}}, {"inject": {}}])
def test_w4a8_routes_around_k6_k7(setup, monkeypatch, seams):
    m, params, pm, pp = setup
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 1)
    monkeypatch.setattr(KM, "quant_w4a8_matmul_qout", _raise)
    monkeypatch.setattr(KM, "quant_w4a8_matmul_q8", _raise)
    _, (ts, tt, tsm, ttm) = _both(_batch())
    pl4 = T4.quantize_model_params_int4(pm, pp)
    lin = T4.make_w4a8_linear_impl(pl4)
    with pytest.raises(AssertionError, match="kernel"):
        pm.encode(pp, ts, tsm, lin=lin)
    mem = pm.encode(pp, ts, tsm, lin=lin, **seams)
    assert torch.equal(mem, pm.encode(pp, ts, tsm, lin=T4.make_w4a8_linear_impl(pl4, fused=False)))
    pm.init_cache(pp, mem, 6, lin=lin, cache_dtype="int8", **seams)


@pytest.mark.parametrize("seams", [{"taps": {}}, {"inject": {}}, {"train": True}])
def test_fused_attn_routes_around_k3(setup, monkeypatch, seams):
    """``fused_attn`` sends a decode step over the int8 cache to K3, but not
    under taps, inject or training."""
    m, params, pm, pp = setup
    monkeypatch.setattr(PT, "decode_attention_int8", _raise)
    _, (ts, tt, tsm, ttm) = _both(_batch())
    lin = TW.make_w8a8_linear_impl(TW.quantize_model_params(pm, pp), "int8")
    mem = pm.encode(pp, ts, tsm, lin=lin)
    tok = torch.zeros((3, 1), dtype=torch.int32)
    cache = pm.init_cache(pp, mem, 6, lin=lin, cache_dtype="int8")
    with pytest.raises(AssertionError, match="kernel"):
        pm.decode_step(pp, cache, tok, 0, tsm, lin=lin, fused_attn=True)
    if "train" in seams:
        h = pm.decode(pp, None, tsm, tok, torch.ones((3, 1, 6), dtype=torch.bool), lin=lin,
                      cache=cache, cache_index=0, fused_attn=True, train=True)
        assert h.shape == (3, 1, 32)
        return
    taps = seams.get("taps")
    got, _ = pm.decode_step(pp, cache, tok, 0, tsm, lin=lin, fused_attn=True, **seams)
    want, _ = pm.decode_step(pp, cache, tok, 0, tsm, lin=lin, fused_attn=False, **seams)
    assert torch.equal(got, want)
    if taps is not None:
        assert "decoder.layers.0.self_attn.probs" in taps


def test_decode_step_taps_match_jax(setup):
    """Taps of one cached decode step over the int8 cache (the tapped
    int8-cache attention) equal JAX's."""
    m, params, pm, pp = setup
    (js, _, jsm, _), (ts, _, tsm, _) = _both(_batch())
    pj = JW.quantize_model_params(m, params)
    lin_j = JW.make_w8a8_linear_impl(pj, "int8")
    lin_t = TW.make_w8a8_linear_impl(TW.quantize_model_params(pm, pp), "int8")
    cj = m.init_cache(params, m.encode(params, js, jsm, lin=lin_j), 6, lin=lin_j,
                      cache_dtype="int8")
    ct = pm.init_cache(pp, pm.encode(pp, ts, tsm, lin=lin_t), 6, lin=lin_t, cache_dtype="int8")
    taps_j, taps_t = {}, {}
    tok = np.full((3, 1), 5, np.int32)
    want, _ = m.decode_step(params, cj, jnp.asarray(tok), 0, jsm, lin=lin_j, taps=taps_j)
    got, _ = pm.decode_step(pp, ct, torch.from_numpy(tok), 0, tsm, lin=lin_t, taps=taps_t)
    assert set(taps_t) == set(taps_j)
    for k, vj in taps_j.items():
        np.testing.assert_allclose(taps_t[k].numpy().astype(np.float32),
                                   np.asarray(vj).astype(np.float32), err_msg=k, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tap_injects_then_records():
    taps = {}
    x = torch.ones(3)
    y = TL.tap("a", x, taps, {"a": lambda v: v * 2})
    assert torch.equal(y, 2 * x) and taps["a"] is y
    assert TL.tap("b", x, None, {"a": lambda v: v * 0}) is x


# ------------------------------------------------------------------ dropout

def test_dropout_identity_when_not_training():
    x = torch.randn(8, 16)
    g = torch.Generator().manual_seed(0)
    assert TL.dropout(x, 0.3, g, False) is x
    assert TL.dropout(x, 0.0, g, True) is x
    assert TL.dropout(x, 0.3, None, True) is x


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_mask_share_and_values(rate):
    x = torch.randn(256, 512, generator=torch.Generator().manual_seed(1)) + 3.0
    y = TL.dropout(x, rate, torch.Generator().manual_seed(2), True)
    kept = y != 0
    keep = 1.0 - rate
    sigma = np.sqrt(keep * rate / x.numel())
    assert abs(kept.float().mean().item() - keep) < 4 * sigma
    np.testing.assert_array_equal(y[kept].numpy(), (x.numpy() / np.float32(keep))[kept.numpy()])
    y2 = TL.dropout(x, rate, torch.Generator().manual_seed(2), True)
    assert torch.equal(y, y2)


def test_training_forward_draws_in_call_order(setup):
    """With ``train`` and a seeded generator the forward is repeatable and
    differs from eval; at dropout 0 it equals JAX's training forward."""
    m, params, pm, pp = setup
    (js, jt, jsm, jtm), (ts, tt, tsm, ttm) = _both(_batch())
    drop = PT.Transformer(pm.cfg.with_(dropout=0.3))
    a = drop.forward(pp, ts, tt, tsm, ttm, torch.Generator().manual_seed(3), True)
    b = drop.forward(pp, ts, tt, tsm, ttm, torch.Generator().manual_seed(3), True)
    assert torch.equal(a, b)
    assert not torch.allclose(a, drop.forward(pp, ts, tt, tsm, ttm))
    # the embedding's dropout draws from the generator in training only
    for train in (False, True):
        g = torch.Generator().manual_seed(5)
        state = g.get_state()
        drop.embed_src(pp, ts, g, train)
        assert torch.equal(g.get_state(), state) != train
    want = m.forward(params, js, jt, jsm, jtm, jax.random.key(0), True)
    got = pm.forward(pp, ts, tt, tsm, ttm, torch.Generator().manual_seed(0), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_xavier_uniform_bound():
    w = TL.xavier_uniform(torch.Generator().manual_seed(0), (64, 32))
    a = np.sqrt(6.0 / 96)
    assert w.shape == (64, 32) and float(w.abs().max()) <= a and float(w.std()) > a / 3


# -------------------------------------------------------------- calibration

class _Batch:
    def __init__(self, seed, torch_side):
        src, tgt, sm, tm = _batch(seed=seed, b=4, s=9, t=8)
        conv = (lambda a: torch.from_numpy(np.array(a))) if torch_side else jnp.asarray
        self.src, self.tgt_in, self.src_mask, self.tgt_mask = map(conv, (src, tgt, sm, tm))


@pytest.mark.parametrize("num_samples", [1, 8])
def test_calibration_matches_jax(setup, num_samples):
    """96 tensors at N=6 (32 here) within rtol 1e-5 of JAX's, the running
    max over ``num_samples + 1`` batches at most."""
    m, params, pm, pp = setup
    want = JC.get_act_scales(m, params, [_Batch(s, False) for s in (1, 2, 3)],
                             num_samples=num_samples, jit=False)
    got = TC.get_act_scales(pm, pp, [_Batch(s, True) for s in (1, 2, 3)],
                            num_samples=num_samples)
    assert set(got) == set(want) and len(got) == 16 * 2
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    # num_samples 1 stops after two batches: the third one's maxima are out
    two = TC.get_act_scales(pm, pp, [_Batch(s, True) for s in (1, 2)])
    three = TC.get_act_scales(pm, pp, [_Batch(s, True) for s in (1, 2, 3)])
    ref = two if num_samples == 1 else three
    assert all(np.array_equal(got[k], ref[k]) for k in got)


def test_calibration_takes_arrays_and_round_trips(setup, tmp_path):
    m, params, pm, pp = setup

    class NpBatch:
        src, tgt_in, src_mask, tgt_mask = _batch(seed=4)

    scales = TC.get_act_scales(pm, pp, [NpBatch()])
    path = str(tmp_path / "scales.npz")
    TC.save_scales(scales, path)
    back = TS.load_reference_scales(path)
    assert set(back) == set(scales)
    for k in scales:
        np.testing.assert_array_equal(back[k], scales[k])
    assert TC.get_act_scales(pm, pp, []) == {}
