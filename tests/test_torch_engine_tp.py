"""The serving engine over a tensor-parallel mesh (``TranslationEngine(...,
mesh=...)``), against the JAX engine over its mesh and the port's engine on
one device, on the CPU.

One gloo world of 4 ranks (``parallel.launch``) runs every case once in a
module-scoped fixture:

- the fp32 engine at ``make_mesh(model=4)`` gives the JAX engine's tokens
  over JAX's ``make_mesh(model=4)`` (``tests/test_engine.py:107-125``), with
  the weights sharded (q (32, 8) on each rank);
- at data=2 x model=2, int8 cache, W8A8 ``int8`` and ``pallas``: the
  one-device engine's tokens, each rank's cache and staging ring holding
  D/2 columns beside whole scales, every rank returning the same requests;
- ``fused_attn`` and W8A8 ``fused`` warn and fall back (to the one-device
  engine's tokens without them); ``beam_size=2`` is refused;
- W4A8 (packed int4 payloads, int8 cache) at ``model=4`` and at data=2 x
  model=2: the one-device engine's tokens, request for request, and at
  ``model=4`` the JAX engine's over its ``make_mesh(model=4)`` with JAX's
  ``make_w4a8_linear_impl`` on the same payloads; K6/K7 step aside with a
  warning.

``jax`` is imported inside the fixture only: the spawned ranks import this
module to find their function.
"""

import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import onnx_transformer_tpu_torch as P
from onnx_transformer_tpu_torch.quant import int4 as TI

DIMS = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4)
MAX_LEN = 12


def _srcs():
    """tests/test_engine.py:22-27."""
    rng = np.random.default_rng(2)
    srcs = rng.integers(4, 31, (9, 10)).astype(np.int32)
    srcs[3, -4:] = 2
    srcs[7, -2:] = 2
    return srcs


def _tokens(eng, srcs):
    ids = [eng.submit(s) for s in srcs]
    got = {r.req_id: r.out_tokens for r in eng.run()}
    return [got[i] for i in ids]


def _engine(model, params, srcs, lin=P.default_linear, mesh=None, **kw):
    eng = P.TranslationEngine(model, params, lin=lin, num_slots=4, src_len=srcs.shape[1],
                              max_len=MAX_LEN, chunk_steps=3, mesh=mesh, **kw)
    return eng, _tokens(eng, srcs)


def _payloads4(np_payloads):
    return {name: {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
            for name, p in np_payloads.items()}


def _world(np_params, srcs, np_payloads4):
    """Every case, on each of 4 ranks; rank 0's dict is returned."""
    model = P.Transformer(P.TransformerConfig(31, 29, **DIMS))
    params = P.params_from_jax(np_params, device="cpu")
    out = {}
    mesh4 = P.make_mesh(model=4, device="cpu")
    eng, out["fp32_tp4"] = _engine(model, params, srcs, mesh=mesh4)
    out["q_shape"] = tuple(eng.params["encoder"]["layers"][0]["self_attn"]["q"]["w"].shape)
    out["chunk"] = eng._chunk.__name__

    mesh = P.make_mesh(data=2, model=2, device="cpu")
    sp, lin8 = P.quantize_transformer(model, params, None, mode="int8")
    for mode in ("int8", "pallas"):
        lin = P.make_w8a8_linear_impl(lin8.payloads, mode=mode)
        eng, tp = _engine(model, sp, srcs, lin=lin, mesh=mesh, kv_cache_dtype="int8")
        _, one = _engine(model, sp, srcs, lin=lin, kv_cache_dtype="int8")
        st = eng._state
        out[mode] = {"tp": tp, "one": one, "fast": eng._stacked is not None,
                     "cache": tuple(st["cache"]["layers"][0]["k"].shape),
                     "scale": tuple(st["cache"]["layers"][0]["k_scale"].shape),
                     "stage": tuple(st["stage"]["layers"][1]["cross_v"].shape),
                     "stage_scale": tuple(st["stage"]["layers"][1]["cross_v_scale"].shape)}
        ranks = [None] * 4
        dist.all_gather_object(ranks, tp)
        out[mode]["ranks_equal"] = all(r == tp for r in ranks)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lin = P.make_w8a8_linear_impl(lin8.payloads, mode="fused")
        eng, tp = _engine(model, sp, srcs, lin=lin, mesh=mesh, kv_cache_dtype="int8",
                          fused_attn=True)
    _, one = _engine(model, sp, srcs, lin=P.make_w8a8_linear_impl(lin8.payloads),
                     kv_cache_dtype="int8")
    out["fallback"] = {"equal": tp == one, "fused_attn": eng.fused_attn,
                       "mode": eng.lin.mode, "warnings": [str(w.message) for w in caught]}
    refused = []
    try:
        P.TranslationEngine(model, sp, num_slots=4, src_len=10, mesh=mesh, beam_size=2)
    except ValueError as e:
        refused.append(str(e))
    out["refused"] = refused

    lin4 = TI.make_w4a8_linear_impl(_payloads4(np_payloads4))
    _, one = _engine(model, params, srcs, lin=lin4, kv_cache_dtype="int8")
    out["w4a8"] = {"one": one}
    for label, m in (("tp4", mesh4), ("dp2tp2", mesh)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng, tp = _engine(model, params, srcs, lin=lin4, mesh=m, kv_cache_dtype="int8")
        ranks = [None] * 4
        dist.all_gather_object(ranks, tp)
        out["w4a8"][label] = {"tp": tp, "ranks_equal": all(r == tp for r in ranks),
                              "q8": hasattr(eng.lin, "linear_q8"),
                              "warnings": [str(w.message) for w in caught],
                              "packed": tuple(eng.lin.payloads[
                                  "encoder.layers.0.feed_forward.w_2"]["wq_packed"].shape)}
    return out


@pytest.fixture(scope="module")
def world():
    import jax

    from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
    from onnx_transformer_tpu.parallel.mesh import make_mesh
    from onnx_transformer_tpu.quant import int4 as JI
    from onnx_transformer_tpu.serving.engine import TranslationEngine

    m = Transformer(TransformerConfig(src_vocab_size=31, tgt_vocab_size=29, dropout=0.0,
                                      **DIMS))
    params = m.init(jax.random.key(5))
    srcs = _srcs()

    def jax_tokens(**kw):
        eng = TranslationEngine(m, params, num_slots=4, src_len=srcs.shape[1],
                                max_len=MAX_LEN, chunk_steps=3, mesh=make_mesh(model=4), **kw)
        ids = [eng.submit(s) for s in srcs]
        got = {r.req_id: r.out_tokens for r in eng.run()}
        return [got[i] for i in ids]

    payloads4 = JI.quantize_model_params_int4(m, params)
    np_payloads4 = jax.tree.map(np.asarray, payloads4)
    out = P.launch(_world, 4, jax.tree.map(np.asarray, params), srcs, np_payloads4,
                   timeout_s=600)
    out["jax_tp4"] = jax_tokens()
    out["jax_w4a8_tp4"] = jax_tokens(lin=JI.make_w4a8_linear_impl(payloads4),
                                     kv_cache_dtype="int8")
    return out


def test_tp4_engine_equals_the_jax_engine_over_its_mesh(world):
    assert world["fp32_tp4"] == world["jax_tp4"]
    assert world["q_shape"] == (32, 8) and world["chunk"] == "_chunk_fn"


@pytest.mark.parametrize("mode", ["int8", "pallas"])
def test_tp2_w8a8_int8_cache_engine_equals_one_device(world, mode):
    got = world[mode]
    assert got["tp"] == got["one"] and got["ranks_equal"] and not got["fast"]
    assert got["cache"] == (4, MAX_LEN, 16) and got["scale"] == (4, MAX_LEN, 1)
    assert got["stage"][1:] == (10, 16) and got["stage_scale"][1:] == (10, 1)


def test_fused_attn_and_fused_warn_and_fall_back(world):
    fb = world["fallback"]
    assert fb["equal"] and fb["fused_attn"] is False and fb["mode"] == "pallas"
    assert any("fused_attn" in w for w in fb["warnings"])
    assert any("'fused'" in w for w in fb["warnings"])


def test_beam_is_refused_under_a_mesh(world):
    (beam,) = world["refused"]
    assert "beam_size > 1" in beam


@pytest.mark.parametrize("label", ["tp4", "dp2tp2"])
def test_w4a8_engine_over_a_mesh_equals_one_device_and_jax(world, label):
    w4 = world["w4a8"]
    got = w4[label]
    assert got["tp"] == w4["one"] and got["ranks_equal"] and not got["q8"]
    assert any("K6/K7" in w for w in got["warnings"])
    # w_2's 64 input rows: 32 packed row pairs split over model
    assert got["packed"] == ((8, 32) if label == "tp4" else (16, 32))
    if label == "tp4":
        assert got["tp"] == world["jax_w4a8_tp4"]
