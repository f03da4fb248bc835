"""Port of quant/int4.py and the int4 primitives of quant/core.py against the
JAX package, on the small config of tests/test_quant.py.

- pack_int4/unpack_int4, the int4 quantize with clip, the per-tensor and
  fake-quant functions and the int4 payloads: bit-equal.
- The STE fake-quant and the QAT linear: forward bit-equal, gradients within
  atol 1e-5 / rtol 1e-5 of jax.grad's (the two frameworks' backward passes
  round the same products in another order).
- The non-fused W4A8 linear: bit-equal on every quantized name.  The fused
  one (FUSED_MIN_TOKENS at 1 in both packages, as tests/test_quant.py:374-380
  does): K6's and K7's plain versions within atol 1e-4 / rtol 1e-5 of the
  JAX kernels run in interpret mode, and bit-equal to the eager JAX chain.
- The int4 chunk-staged decode and the int4 KV-cached int8-cache decode:
  tokens identical to JAX's non-fused decodes, and >= 95 % against JAX's
  fused ones (tests/test_quant.py:381)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_transformer_tpu.quant.w8a8 as JW
from onnx_transformer_tpu.models import stacked_decode as JSD
from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import core as JQ
from onnx_transformer_tpu.quant import int4 as JI
from onnx_transformer_tpu.serving import decode as JD
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import stacked_decode as TSD
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K
from onnx_transformer_tpu_torch.quant import core as TQ
from onnx_transformer_tpu_torch.quant import int4 as TI
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving import decode as TD

DIMS = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4)
MAX_LEN = 12


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    m = Transformer(TransformerConfig(src_vocab_size=37, tgt_vocab_size=31, **DIMS))
    params = m.init(jax.random.key(2))
    pm = PT.Transformer(PT.TransformerConfig(37, 31, **DIMS))
    pp = params_from_jax(params, device="cpu")
    src = np.random.default_rng(0).integers(4, 37, (6, 9)).astype(np.int32)
    src[2, -4:] = 2
    return {"jax": (m, params, JI.quantize_model_params_int4(m, params)),
            "torch": (pm, pp, TI.quantize_model_params_int4(pm, pp)), "src": src}


@pytest.fixture
def fused_everywhere():
    old = (JW.FUSED_MIN_TOKENS, TW.FUSED_MIN_TOKENS)
    JW.FUSED_MIN_TOKENS = TW.FUSED_MIN_TOKENS = 1
    try:
        yield
    finally:
        JW.FUSED_MIN_TOKENS, TW.FUSED_MIN_TOKENS = old


# ------------------------------------------------------------- primitives

def test_pack_unpack_bit_equal():
    # every (lo, hi) pair of nibble values, then a random [64, 96]
    vals = np.arange(-8, 8, dtype=np.int8)
    pairs = np.stack([np.repeat(vals, 16), np.tile(vals, 16)])          # [2, 256]
    rand = np.random.default_rng(1).integers(-8, 8, (64, 96)).astype(np.int8)
    for q in (pairs, rand):
        pj = np.asarray(JQ.pack_int4(jnp.asarray(q)))
        pt = TQ.pack_int4(_t(q))
        assert pt.dtype == torch.uint8 and pt.shape == (q.shape[0] // 2, q.shape[1])
        np.testing.assert_array_equal(pt.numpy(), pj)
        ut = TQ.unpack_int4(pt)
        assert ut.dtype == torch.int8
        np.testing.assert_array_equal(ut.numpy(), np.asarray(JQ.unpack_int4(jnp.asarray(pj))))
        np.testing.assert_array_equal(ut.numpy(), q)
    assert len(set(TQ.pack_int4(_t(pairs)).tolist()[0])) == 256


@pytest.mark.parametrize("bits,clip,shrink", [(4, True, 0.6), (4, False, 1.0), (8, True, 0.5),
                                              (8, False, 1.0)])
def test_quantize_bits_clip(bits, clip, shrink):
    """A calibrated scale below the absmax one needs the clip."""
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(9, 33)).astype(np.float32)
    s = (np.abs(x).max(-1, keepdims=True) / JQ.qmax_for(bits) * shrink).astype(np.float32)
    want = np.asarray(JQ.quantize(jnp.asarray(x), jnp.asarray(s), bits, clip))
    got = TQ.quantize(_t(x), _t(s), bits, clip)
    np.testing.assert_array_equal(got.numpy(), want)
    if clip:
        assert np.abs(got.numpy()).max() == JQ.qmax_for(bits)


@pytest.mark.parametrize("bits", [4, 8])
def test_per_tensor_and_fake_quant_bit_equal(bits):
    x = (np.random.default_rng(3).normal(size=(17, 40)) * 3).astype(np.float32)
    for fj, ft in ((JQ.quantize_weight_per_tensor, TQ.quantize_weight_per_tensor),
                   (JQ.quantize_act_per_tensor, TQ.quantize_act_per_tensor)):
        qj, sj = fj(jnp.asarray(x), bits)
        qt, st = ft(_t(x), bits)
        assert st.ndim == 0
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for fj, ft in ((JQ.fake_quant_act_per_tensor, TQ.fake_quant_act_per_tensor),
                   (JQ.fake_quant_weight_per_channel, TQ.fake_quant_weight_per_channel),
                   (JQ.fake_quant_act_per_token, TQ.fake_quant_act_per_token)):
        np.testing.assert_array_equal(ft(_t(x), bits).numpy(), np.asarray(fj(jnp.asarray(x), bits)))
    wj, swj = JQ.quantize_weight_per_channel(jnp.asarray(x), bits)
    wt, swt = TQ.quantize_weight_per_channel(_t(x), bits)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(swt.numpy(), np.asarray(swj))


@pytest.mark.parametrize("bits", [4, 8])
def test_ste_fake_quant_grad_matches_jax(bits):
    """The absmax element lands on the clamp's bound: jnp.clip gives it half
    the gradient, and so must the port."""
    rng = np.random.default_rng(bits + 10)
    x = rng.normal(size=(6, 24)).astype(np.float32)
    r = rng.normal(size=(6, 24)).astype(np.float32)

    def loss_j(x):
        return jnp.sum(JQ.fake_quant_ste(x, JQ.act_scale_per_token(x, bits), bits) * r)

    xt = _t(x).requires_grad_(True)
    yt = TQ.fake_quant_ste(xt, TQ.act_scale_per_token(xt, bits), bits)
    np.testing.assert_array_equal(
        yt.detach().numpy(),
        np.asarray(JQ.fake_quant_ste(jnp.asarray(x), JQ.act_scale_per_token(jnp.asarray(x), bits),
                                     bits)))
    (yt * _t(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax.grad(loss_j)(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    # ste_round alone: round half to even forward, identity backward
    z = torch.tensor([0.5, 1.5, -2.5, 2.4], requires_grad=True)
    out = TQ.ste_round(z)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(JQ.ste_round(jnp.asarray(z.detach().numpy()))))
    out.sum().backward()
    assert torch.equal(z.grad, torch.ones(4))


# --------------------------------------------------------------- payloads

def test_int4_payloads_bit_equal(setup):
    _, _, pj = setup["jax"]
    _, _, pt = setup["torch"]
    assert set(pj) == set(pt) and "generator.proj" not in pt
    for name in pj:
        assert pt[name]["wq_packed"].dtype == torch.uint8
        for key in ("wq_packed", "sw", "b"):
            np.testing.assert_array_equal(pt[name][key].numpy(), np.asarray(pj[name][key]))


def _x(name, seed):
    d = 64 if "w_2" in name else 32
    return np.random.default_rng(seed).normal(size=(4, 7, d)).astype(np.float32)


def test_w4a8_nonfused_linear_bit_equal(setup):
    _, _, pj = setup["jax"]
    _, _, pt = setup["torch"]
    lin_j = JI.make_w4a8_linear_impl(pj, fused=False)
    lin_t = TI.make_w4a8_linear_impl(pt, fused=False)
    assert lin_t.quantized_output_grid and lin_t.payloads is pt
    assert not hasattr(lin_t, "linear_q8")
    for i, name in enumerate(pj):
        x = _x(name, i)
        np.testing.assert_array_equal(lin_t(name, _t(x), None, None).numpy(),
                                      np.asarray(lin_j(name, jnp.asarray(x), None, None)),
                                      err_msg=name)
    # an unquantized linear is the plain fp one
    x, w = _t(_x("a", 0)), torch.ones(32, 5)
    assert torch.equal(lin_t("generator.proj", x, w, None), TL.linear(x, w))


def test_w4a8_fused_matches_jax(setup, fused_everywhere, monkeypatch):
    """q/k/v go to K6 (its plain version on the CPU), FFN and output
    projections to the chain; linear_q8 gives K7 for q/k/v only."""
    _, _, pj = setup["jax"]
    _, _, pt = setup["torch"]
    calls = []

    def spy(fn):
        def wrapper(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapper

    for name in ("quant_w4a8_matmul_qout", "quant_w4a8_matmul_q8"):
        monkeypatch.setattr(K, name, spy(getattr(K, name)))
    lin_j = JI.make_w4a8_linear_impl(pj)
    lin_jx = JI.make_w4a8_linear_impl(pj, fused=False)
    lin_t = TI.make_w4a8_linear_impl(pt)
    for i, name in enumerate(["encoder.layers.0.self_attn.linears.0",
                              "decoder.layers.1.src_attn.linears.2",
                              "encoder.layers.1.feed_forward.w_2",
                              "decoder.layers.0.self_attn.linears.3"]):
        x = _x(name, 20 + i)
        calls.clear()
        got = lin_t(name, _t(x), None, None).numpy()
        assert calls == (["quant_w4a8_matmul_qout"] if TW.is_quantized_output(name) else [])
        np.testing.assert_allclose(got, np.asarray(lin_j(name, jnp.asarray(x), None, None)),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(lin_jx(name, jnp.asarray(x), None, None)),
                                      err_msg=name)
    name = "decoder.layers.1.src_attn.linears.1"
    x = _x(name, 30)
    qj, sj = lin_j.linear_q8(name, jnp.asarray(x))
    qt, st = lin_t.linear_q8(name, _t(x))
    np.testing.assert_allclose((qt.float() * st).numpy(), np.asarray(qj, np.float32) * np.asarray(sj),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    chain = np.asarray(lin_jx(name, jnp.asarray(x), None, None))
    np.testing.assert_array_equal((qt.float() * st).numpy(), chain)
    assert lin_t.linear_q8("decoder.layers.1.src_attn.linears.3", _t(x)) is None
    assert lin_j.linear_q8("decoder.layers.1.src_attn.linears.3", jnp.asarray(x)) is None


def test_w4a8_gates(setup, monkeypatch):
    """Below FUSED_MIN_TOKENS (read at call time) nothing takes a kernel;
    a_bits other than 8 never does; K or N over 2048 stays on the chain."""
    _, _, pt = setup["torch"]
    called = []
    monkeypatch.setattr(K, "quant_w4a8_matmul_qout", lambda *a: called.append(1))
    name = "encoder.layers.0.self_attn.linears.1"
    x = _t(_x(name, 40))
    assert TW.FUSED_MIN_TOKENS == 8192
    TI.make_w4a8_linear_impl(pt)(name, x, None, None)
    assert TI.make_w4a8_linear_impl(pt).linear_q8(name, x) is None
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 1)
    TI.make_w4a8_linear_impl(pt, a_bits=6)(name, x, None, None)
    assert TI.make_w4a8_linear_impl(pt, a_bits=6).linear_q8(name, x) is None
    assert not called
    big = {name: {"wq_packed": torch.zeros(2048, 64, dtype=torch.uint8),
                  "sw": torch.ones(64), "b": torch.zeros(64)}}
    TI.make_w4a8_linear_impl(big)(name, torch.ones(3, 4096), None, None)
    assert not called
    TI.make_w4a8_linear_impl(pt)(name, x, None, None)
    assert called == [1]


# -------------------------------------------------------------------- QAT

@pytest.mark.parametrize("name,d_in,d_out", [
    ("encoder.layers.0.self_attn.linears.1", 32, 32),    # q/k/v: output fake-quant too
    ("decoder.layers.1.feed_forward.w_1", 32, 64),
    ("generator.proj", 32, 31),                          # weight-only
    ("other.proj", 32, 8),                               # stays fp
])
def test_qat_linear_grads_match_jax(name, d_in, d_out):
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(3, 5, d_in)).astype(np.float32)
    w = (rng.normal(size=(d_in, d_out)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(d_out,)) * 0.1).astype(np.float32)
    r = rng.normal(size=(3, 5, d_out)).astype(np.float32)
    lin_j = JI.make_qat_linear_impl()

    def loss_j(x, w, b):
        return jnp.sum(lin_j(name, x, w, b) * r)

    want = np.asarray(lin_j(name, *map(jnp.asarray, (x, w, b))))
    gj = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (_t(a).requires_grad_(True) for a in (x, w, b))
    y = TI.make_qat_linear_impl()(name, xt, wt, bt)
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-6, rtol=1e-6)
    (y * _t(r)).sum().backward()
    for got, g in zip((xt.grad, wt.grad, bt.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=1e-5, rtol=1e-5)


def test_qat_forward_param_grads_match_jax(setup):
    """Through the whole teacher-forced forward: hidden states and the
    gradient of every parameter, with q and k trained straight through the
    probability rounding as in the JAX package.  The hidden states agree
    within 1e-5 (XLA and PyTorch sum the f32 products in other orders), and
    through the STE chain those last-ulp differences move a few int8
    roundings; so each gradient is held within rtol 1e-5 and an atol of 1e-6
    of the largest gradient of the tree (about 9e-5 here), where a
    per-linear gradient (test above) is held within 1e-5 outright."""
    m, params, _ = setup["jax"]
    pm = setup["torch"][0]
    rng = np.random.default_rng(8)
    src = rng.integers(4, 37, (3, 7)).astype(np.int32)
    tgt = rng.integers(4, 31, (3, 5)).astype(np.int32)
    lin_j = JI.make_qat_linear_impl()

    def loss_j(p):
        sj, tj = jnp.asarray(src), jnp.asarray(tgt)
        h = m.forward(p, sj, tj, JL.make_src_mask(sj), JL.make_tgt_mask(tj), lin=lin_j)
        return jnp.sum(h ** 2)

    gj = jax.grad(loss_j)(params)
    pp = params_from_jax(params, device="cpu")
    leaves = jax.tree_util.tree_leaves(pp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    st, tt = _t(src), _t(tgt)
    h = pm.forward(pp, st, tt, TL.make_src_mask(st), TL.make_tgt_mask(tt),
                   lin=TI.make_qat_linear_impl())
    sj, tj = jnp.asarray(src), jnp.asarray(tgt)
    hj = m.forward(params, sj, tj, JL.make_src_mask(sj), JL.make_tgt_mask(tj), lin=lin_j)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)
    (h ** 2).sum().backward()
    paths = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(paths) == len(leaves)
    atol = 1e-6 * max(float(np.abs(np.asarray(g)).max()) for _, g in paths)
    for (path, g), leaf in zip(paths, leaves):
        g = np.asarray(g)
        if leaf.grad is None:   # the generator: not in the forward
            assert not g.any(), jax.tree_util.keystr(path)
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=atol, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    # q and k learn through the probabilities
    assert pp["decoder"]["layers"][0]["self_attn"]["q"]["w"].grad.abs().max() > 0


# ---------------------------------------------------------------- decodes

def _unpacked(payloads, unpack):
    return {n: {"wq": unpack(p["wq_packed"]), "sw": p["sw"], "b": p["b"]}
            for n, p in payloads.items()}


def _decodes(setup, fused: bool) -> dict:
    """The int4 chunk-staged and KV-cached int8-cache decodes of both
    packages (kept for the module: the JAX side's first calls compile)."""
    key = ("decodes", fused, TW.FUSED_MIN_TOKENS)
    if key not in setup:
        setup[key] = _run_decodes(setup, fused)
    return setup[key]


def _run_decodes(setup, fused: bool) -> dict:
    m, params, pj = setup["jax"]
    pm, pp, pt = setup["torch"]
    src = setup["src"]
    sj, stt = jnp.asarray(src), _t(src)
    smj, smt = JL.make_src_mask(sj), TL.make_src_mask(stt)
    lin_j = JI.make_w4a8_linear_impl(pj, fused=fused)
    lin_t = TI.make_w4a8_linear_impl(pt, fused=fused)
    stacked_j = JSD.build_stacked(m, params, _unpacked(pj, JQ.unpack_int4))
    stacked_t = TSD.build_stacked(pm, pp, _unpacked(pt, TQ.unpack_int4))
    return {
        "chunked": (np.array(JSD.greedy_decode_chunked(m, params, stacked_j, sj, smj, MAX_LEN,
                                                       chunk=4, lin=lin_j)),
                    TSD.greedy_decode_chunked(pm, pp, stacked_t, stt, smt, MAX_LEN, chunk=4,
                                              lin=lin_t).numpy()),
        "kv_int8": (np.array(JD.greedy_decode(m, params, sj, smj, MAX_LEN, lin=lin_j,
                                              kv_cache_dtype="int8")),
                    TD.greedy_decode(pm, pp, stt, smt, MAX_LEN, lin=lin_t,
                                     kv_cache_dtype="int8").numpy()),
    }


def test_int4_decodes_identical_to_jax(setup):
    for kind, (ys_j, ys_t) in _decodes(setup, fused=False).items():
        assert ys_t.shape == (6, MAX_LEN)
        np.testing.assert_array_equal(ys_t, ys_j, err_msg=kind)


def test_int4_fused_decodes_match_jax(setup, fused_everywhere):
    plain = _decodes(setup, fused=False)
    for kind, (ys_j, ys_t) in _decodes(setup, fused=True).items():
        agree = np.mean(ys_t == ys_j)
        assert agree >= 0.95, f"{kind}: token agreement {agree}"
        # the port's kernel plain versions are bit-equal to its chain
        np.testing.assert_array_equal(ys_t, plain[kind][1], err_msg=kind)
