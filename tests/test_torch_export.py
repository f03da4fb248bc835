"""Port of export/serialize.py against the JAX package's exported bundles.

On the small configurations of tests/test_export.py (vocabularies 31/29 and
41/37, 2 layers, d_model 32, d_ff 64, 4 heads), the same params go to
both packages' ``export_model``:

- fp32: the loaded encoder within rtol/atol 1e-5 of JAX's exported
  encoder; the greedy program's tokens and the prefill + decode-step loop's
  equal JAX's exported ones; ``params.npz`` restored by JAX's
  ``checkpoint.restore`` bit for bit; the manifest has JAX's keys;
- W8A8 int8 with the int8 cache: the greedy tokens equal JAX's export, and
  the decode-step programs of both packages driven at per-row positions
  give the same tokens;
- a loaded program takes params whose dicts hold their keys in another
  order (a checkpoint's), as a JAX pytree does;
- export safety: the prefill and then the W8A8 decode step export in one
  process with the constant caches empty (a traced tensor is never cached)
  and eager results are unchanged after; the decode step holds no size that
  depends on the data; a 0-dim position is refused with a clear message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.export import serialize as JS
from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu.serving import decode as JD
from onnx_transformer_tpu.train import checkpoint as JC
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.export import serialize as TS
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.quant import core as TQ
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving import decode as TD

JAX_MANIFEST_KEYS = {"format", "model", "mode", "kv_cache_dtype", "config", "src_len",
                     "max_len", "batch_buckets", "graphs", "decode_step_signature"}


def _models(src_vocab, tgt_vocab, seed):
    dims = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4)
    m = Transformer(TransformerConfig(src_vocab, tgt_vocab, dropout=0.0, **dims))
    params = m.init(jax.random.key(seed))
    pm = PT.Transformer(PT.TransformerConfig(src_vocab, tgt_vocab, **dims))
    return m, params, pm, params_from_jax(params, device="cpu")


def _loop(call_pre, call_step, src, sm, max_len, shift=None):
    """A consumer's token loop over a prefill and a decode step (numpy in,
    numpy out); row b runs ``shift[b]`` steps behind (its position clipped
    at 0), so rows sit at different positions."""
    b = src.shape[0]
    shift = np.zeros(b, np.int32) if shift is None else shift
    cache = call_pre(src, sm)
    ys = np.full((b, max_len), 2, np.int32)
    ys[:, 0] = 0
    last = ys[:, :1]
    for i in range(max_len - 1):
        pos = np.maximum(i - shift, 0).astype(np.int32)
        logp, cache = call_step(cache, last, pos, sm)
        nxt = np.asarray(logp).argmax(-1).astype(np.int32)
        ys[:, i + 1] = nxt
        last = nxt[:, None]
    return ys


def _port_calls(out, b, params):
    pre = TS.load_exported(out, f"prefill_b{b}.pt2")
    step = TS.load_exported(out, f"decode_step_b{b}.pt2")

    def call_pre(src, sm):
        return pre.call(params, torch.from_numpy(src), torch.from_numpy(sm))

    def call_step(cache, last, pos, sm):
        logp, cache = step.call(params, cache, torch.from_numpy(np.ascontiguousarray(last)),
                                torch.from_numpy(pos), torch.from_numpy(sm))
        return logp.numpy(), cache

    return call_pre, call_step


def _jax_calls(out, b, params):
    pre = JS.load_exported(out, f"prefill_b{b}.shlo")
    step = JS.load_exported(out, f"decode_step_b{b}.shlo")
    return (lambda src, sm: pre.call(params, src, sm),
            lambda cache, last, pos, sm: step.call(params, cache, last, pos, sm))


@pytest.fixture(scope="module")
def fp32(tmp_path_factory):
    """tests/test_export.py:11-20: both packages' fp32 bundles, bucket 2."""
    m, params, pm, pp = _models(31, 29, 3)
    jout = str(tmp_path_factory.mktemp("jax_fp32"))
    tout = str(tmp_path_factory.mktemp("torch_fp32"))
    JS.export_model(m, params, jout, batch_sizes=(2,), src_len=8, max_len=10)
    bundle = TS.export_model(pm, pp, tout, batch_sizes=(2,), src_len=8, max_len=10)
    src = np.random.default_rng(0).integers(4, 31, (2, 8)).astype(np.int32)
    src[1, -2:] = 2
    sm = np.array(JL.make_src_mask(jnp.asarray(src)))
    return m, params, pp, jout, tout, bundle, src, sm


def test_fp32_encoder_matches_jax_export(fp32):
    m, params, pp, jout, tout, _, src, sm = fp32
    want = np.asarray(JS.load_exported(jout, "encoder_b2.shlo").call(params, src, sm))
    got = TS.load_exported(tout, "encoder_b2.pt2").call(pp, torch.from_numpy(src),
                                                        torch.from_numpy(sm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_programs_take_params_in_any_key_order(fp32):
    m, params, pp, jout, tout, _, src, sm = fp32

    def reversed_keys(tree):
        if isinstance(tree, dict):
            return {k: reversed_keys(tree[k]) for k in reversed(list(tree))}
        if isinstance(tree, list):
            return [reversed_keys(v) for v in tree]
        return tree

    enc = TS.load_exported(tout, "encoder_b2.pt2")
    tsrc, tsm = torch.from_numpy(src), torch.from_numpy(sm)
    assert torch.equal(enc.call(reversed_keys(pp), tsrc, tsm), enc.call(pp, tsrc, tsm))


def test_fp32_greedy_matches_jax_export(fp32):
    m, params, pp, jout, tout, _, src, sm = fp32
    want = np.asarray(JS.load_exported(jout, "greedy_b2.shlo").call(params, src, sm))
    got = TS.load_exported(tout, "greedy_b2.pt2").call(pp, torch.from_numpy(src),
                                                       torch.from_numpy(sm))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp32_token_loop_matches_jax_export(fp32):
    m, params, pp, jout, tout, _, src, sm = fp32
    want = _loop(*_jax_calls(jout, 2, params), src, sm, 10)
    got = _loop(*_port_calls(tout, 2, pp), src, sm, 10)
    np.testing.assert_array_equal(got, want)
    live = np.asarray(JD.greedy_decode(m, params, jnp.asarray(src), jnp.asarray(sm), 10,
                                       stop_at_eos=False))
    np.testing.assert_array_equal(got, live)


def test_params_npz_restores_in_jax_bit_for_bit(fp32):
    m, params, pp, jout, tout, _, src, sm = fp32
    restored = JC.restore(f"{tout}/params.npz", params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_manifest_has_jax_keys(fp32):
    m, params, pp, jout, tout, bundle, src, sm = fp32
    jm, tm = JS.load_manifest(jout), TS.load_manifest(tout)
    assert set(jm) == set(tm) == JAX_MANIFEST_KEYS
    assert tm["format"] == "torch.export"
    for key in ("model", "mode", "kv_cache_dtype", "config", "src_len", "max_len",
                "batch_buckets", "decode_step_signature"):
        assert tm[key] == jm[key], key
    assert tm["graphs"] == {g: [f.replace(".shlo", ".pt2") for f in files]
                            for g, files in jm["graphs"].items()}
    assert sorted(bundle.seconds) == sorted(f for files in tm["graphs"].values() for f in files)


@pytest.fixture(scope="module")
def int8(tmp_path_factory):
    """tests/test_export.py:60-87 and 129-160: W8A8 int8 with the int8
    cache, bucket 4."""
    m, params, pm, pp = _models(41, 37, 7)
    sp, lin8 = JW.quantize_transformer(m, params, mode="int8")
    psp, plin8 = TW.quantize_transformer(pm, params_from_jax(params, device="cpu"), mode="int8")
    jout = str(tmp_path_factory.mktemp("jax_int8"))
    tout = str(tmp_path_factory.mktemp("torch_int8"))
    JS.export_model(m, sp, jout, batch_sizes=(4,), src_len=9, max_len=12, lin=lin8,
                    mode="int8", kv_cache_dtype="int8")
    TS.export_model(pm, psp, tout, batch_sizes=(4,), src_len=9, max_len=12, lin=plin8,
                    mode="int8", kv_cache_dtype="int8")
    src = np.random.default_rng(3).integers(4, 41, (4, 9)).astype(np.int32)
    sm = np.array(JL.make_src_mask(jnp.asarray(src)))
    return sp, psp, jout, tout, src, sm


def test_int8_greedy_matches_jax_export(int8):
    sp, psp, jout, tout, src, sm = int8
    assert TS.load_manifest(tout)["mode"] == "int8"
    want = np.asarray(JS.load_exported(jout, "greedy_b4.shlo").call(sp, src, sm))
    got = TS.load_exported(tout, "greedy_b4.pt2").call(psp, torch.from_numpy(src),
                                                       torch.from_numpy(sm))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_decode_step_at_per_row_positions_matches_jax_export(int8):
    sp, psp, jout, tout, src, sm = int8
    shift = np.array([0, 1, 3, 0], np.int32)
    want = _loop(*_jax_calls(jout, 4, sp), src, sm, 12, shift)
    got = _loop(*_port_calls(tout, 4, psp), src, sm, 12, shift)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def w8a8_small():
    m, params, pm, pp = _models(41, 37, 11)
    psp, plin = TW.quantize_transformer(pm, pp, mode="int8")
    src = torch.from_numpy(np.random.default_rng(4).integers(4, 41, (3, 9)).astype(np.int32))
    return pm, psp, plin, src, TL.make_src_mask(src)


def test_prefill_then_w8a8_step_export_with_empty_caches(w8a8_small, tmp_path):
    """Tracing the prefill first with the constant caches empty used to
    cache traced tensors, which the decode step's trace then refused."""
    pm, psp, plin, src, sm = w8a8_small
    before = TD.greedy_decode(pm, psp, src, sm, 8, lin=plin, kv_cache_dtype="int8")
    TQ._const.cache_clear()
    TL.pe_rows.cache_clear()
    TS.export_model(pm, psp, str(tmp_path), batch_sizes=(3,), src_len=9, max_len=8, lin=plin,
                    mode="int8", kv_cache_dtype="int8", graphs=("prefill", "decode_step"))
    # what the traces cached are real tensors
    for fn in (TQ._const, TL.pe_rows):
        assert fn.cache_info().currsize > 0
    cpu = torch.device("cpu")
    for t in (TQ._const(127.0, torch.float32, cpu), TL.pe_rows(5000, 32, cpu, torch.float32)):
        assert type(t) is torch.Tensor
    after = TD.greedy_decode(pm, psp, src, sm, 8, lin=plin, kv_cache_dtype="int8")
    assert torch.equal(before, after)
    loop = _loop(*_port_calls(str(tmp_path), 3, psp), src.numpy(), sm.numpy(), 8)
    eager = TD.greedy_decode(pm, psp, src, sm, 8, lin=plin, kv_cache_dtype="int8",
                             stop_at_eos=False)
    np.testing.assert_array_equal(loop, eager.numpy())


def test_decode_step_holds_no_data_dependent_size(w8a8_small, tmp_path):
    """The per-row cache write drops an out-of-range row without a boolean
    mask, so the traced step has static shapes only; the loaded step drops
    that row's write as eager does."""
    from torch.fx.experimental.symbolic_shapes import free_unbacked_symbols

    pm, psp, plin, src, sm = w8a8_small
    TS.export_model(pm, psp, str(tmp_path), batch_sizes=(3,), src_len=9, max_len=8, lin=plin,
                    mode="int8", kv_cache_dtype="int8", graphs=("prefill", "decode_step"))
    step = TS.load_exported(str(tmp_path), "decode_step_b3.pt2")
    for node in step.program.graph.nodes:
        val = node.meta.get("val")
        assert not free_unbacked_symbols(val), node
    pre = TS.load_exported(str(tmp_path), "prefill_b3.pt2")
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    pos = torch.tensor([0, 8, 2], dtype=torch.int32)    # row 1 out of range: dropped
    logp_l, cache_l = step.call(psp, pre.call(psp, src, sm), tok, pos, sm)
    cache_e = pm.init_cache(psp, pm.encode(psp, src, sm, lin=plin), 8, lin=plin,
                            cache_dtype="int8")
    logp_e, cache_e = pm.decode_step(psp, cache_e, tok, pos, sm, lin=plin)
    assert torch.equal(logp_l, logp_e)
    for lc_l, lc_e in zip(cache_l["layers"], cache_e["layers"]):
        for key in lc_e:
            assert torch.equal(lc_l[key], lc_e[key]), key
    assert not cache_e["layers"][0]["k"][1].any()


def test_a_traced_step_refuses_a_0dim_position(w8a8_small):
    pm, psp, plin, src, sm = w8a8_small
    cache = pm.init_cache(psp, pm.encode(psp, src, sm, lin=plin), 8, lin=plin,
                          cache_dtype="int8")

    def step(params, cache, tok, pos, src_mask):
        return pm.decode_step(params, cache, tok, pos, src_mask, lin=plin)

    with pytest.raises(ValueError, match=r"\[B\] tensor of positions"):
        torch.export.export(TS._Program(step), (psp, cache, torch.zeros((3, 1), dtype=torch.int32),
                                                torch.tensor(0, dtype=torch.int32), sm),
                            strict=False)
