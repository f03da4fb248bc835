"""Port of parallel/ (mesh, shardings, collectives, launch) and the
tensor-parallel decodes, against the JAX package on the CPU.

The port runs one process per rank: a module-scoped fixture launches one
gloo world of 4 ranks (``parallel.launch``) that computes every case once,
and the tests assert on what rank 0 hands back.  JAX's side runs here over
``make_mesh(model=4)`` on the 8 virtual CPU devices of ``conftest.py``, on
the same seeded weights (``tests/test_parallel.py``):

- ``param_pspecs`` equals JAX's leaf for leaf; a rank's shards have JAX's
  shard shapes;
- the fp32 greedy decode at TP=4 gives JAX's tokens, single-device and over
  its mesh; data=2 x model=2 gives the full decode's; beam at TP=2 equals
  one device;
- W8A8 ``int8`` and ``pallas`` (K5's plain version on the CPU) at TP=2:
  logits and the int8 cache bit-equal to one device; ``fake`` tokens equal;
  ``fused`` and ``fused_attn`` warn and fall back;
- W4A8 (packed int4) at TP=2: logits and the int8 cache bit-equal to one
  device, tokens equal; K6/K7 step aside with a warning, and the
  column-parallel linears (and only they) call K8 (``quant_w4a8_matmul``,
  its plain version on the CPU).

``jax`` is imported inside the fixtures only: the spawned ranks import this
module to find their function.
"""

import os
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import onnx_transformer_tpu_torch as P
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.parallel import mesh as PM
from onnx_transformer_tpu_torch.parallel import sharding as TS
from onnx_transformer_tpu_torch.quant import core as TQ
from onnx_transformer_tpu_torch.quant import int4 as TI
from onnx_transformer_tpu_torch.quant import w8a8 as TW

DIMS = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4)
MAX_LEN = 10


def _src(b=8, s=9, sv=31, seed=1):
    """tests/test_parallel.py:_src."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, sv, (b, s)).astype(np.int32)
    src[1, -3:] = 2
    return src


def _gather_cols(t, mesh):
    """A tensor whose last dim is spread over the model group, whole."""
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=-1)


def _w8a8_steps(m1, mt, sp, spt, l1, lt, src, sm, steps=4):
    """Memory, per-step raw logits and the int8 caches after ``steps``
    steps, one device against the tensor-parallel view (caches whole)."""
    mem1 = m1.encode(sp, src, sm, lin=l1)
    memt = mt.encode(spt, src, sm, lin=lt)
    c1 = m1.init_cache(sp, mem1, MAX_LEN, lin=l1, cache_dtype="int8")
    ct = mt.init_cache(spt, memt, MAX_LEN, lin=lt, cache_dtype="int8")
    tok = torch.zeros((src.shape[0], 1), dtype=torch.int32)
    same_logits = []
    for i in range(steps):
        lg1, c1 = m1.decode_step(sp, c1, tok, i, sm, lin=l1, log_probs=False)
        lgt, ct = mt.decode_step(spt, ct, tok, i, sm, lin=lt, log_probs=False)
        same_logits.append(bool(torch.equal(lg1, lgt)))
        tok = torch.argmax(lg1, dim=-1).to(torch.int32)[:, None]
    same_cache = all(
        torch.equal(c1["layers"][i][k], _gather_cols(ct["layers"][i][k], mt.mesh))
        for i in range(len(c1["layers"])) for k in ("k", "v", "cross_k", "cross_v"))
    same_scales = all(
        torch.equal(c1["layers"][i][k], ct["layers"][i][k])
        for i in range(len(c1["layers"]))
        for k in ("k_scale", "v_scale", "cross_k_scale", "cross_v_scale"))
    return {"memory": bool(torch.equal(mem1, memt)), "logits": same_logits,
            "cache": same_cache, "scales": same_scales,
            "cache_width": ct["layers"][0]["k"].shape[-1]}


def _world(np_params, src8, src4):
    """Every case, on each of 4 ranks; rank 0's dict is returned."""
    cfg = P.TransformerConfig(31, 29, **DIMS)
    m1 = P.Transformer(cfg)
    params = P.params_from_jax(np_params, device="cpu")
    out = {}
    s8, s4 = torch.from_numpy(src8), torch.from_numpy(src4)
    sm8, sm4 = TL.make_src_mask(s8), TL.make_src_mask(s4)

    mesh4 = P.make_mesh(model=4, device="cpu")
    out["mesh4"] = (mesh4.data, mesh4.model, mesh4.data_rank, mesh4.model_rank)
    sh4 = P.shard_params(params, mesh4)
    att = sh4["encoder"]["layers"][0]["self_attn"]
    out["shapes"] = {(k, p): tuple(att[k][p].shape) for k in ("q", "o") for p in ("w", "b")}
    full_q = params["encoder"]["layers"][0]["self_attn"]["q"]["w"]
    placements = TS.param_shardings(params)["encoder"]["layers"][0]["self_attn"]["q"]["w"]
    from torch.distributed.tensor import distribute_tensor

    out["dtensor_local"] = bool(torch.equal(
        distribute_tensor(full_q, mesh4.device_mesh, placements).to_local(), att["q"]["w"]))
    m4 = P.Transformer(cfg, mesh4)
    out["tp4"] = P.greedy_decode(m4, sh4, s8, sm8, MAX_LEN)
    out["one"] = P.greedy_decode(m1, params, s8, sm8, MAX_LEN)
    ranks = [None] * 4
    dist.all_gather_object(ranks, out["tp4"])
    out["tp4_ranks_equal"] = all(torch.equal(r, out["tp4"]) for r in ranks)

    mesh22 = P.make_mesh(data=2, model=2, device="cpu")
    out["mesh22"] = (mesh22.data, mesh22.model, mesh22.data_rank, mesh22.model_rank)
    m22 = P.Transformer(cfg, mesh22)
    sh22 = P.shard_params(params, mesh22)
    out["dp2tp2"] = P.greedy_decode(m22, sh22, s8, sm8, MAX_LEN)
    out["beam_tp"] = P.beam_decode(m22, sh22, s4, sm4, 8, beam_size=2)
    out["beam_one"] = P.beam_decode(m1, params, s4, sm4, 8, beam_size=2)

    sp, lin8 = P.quantize_transformer(m1, params, None, mode="int8")
    spt = P.shard_params(sp, mesh22)
    for mode in ("int8", "pallas", "fake"):
        l1 = P.make_w8a8_linear_impl(lin8.payloads, mode=mode)
        lt = P.shard_linear_impl(l1, mesh22)
        out[f"w8a8_{mode}"] = _w8a8_steps(m1, m22, sp, spt, l1, lt, s8, sm8)
        out[f"w8a8_{mode}_tokens"] = (
            P.greedy_decode(m22, spt, s8, sm8, MAX_LEN, lin=lt, kv_cache_dtype="int8"),
            P.greedy_decode(m1, sp, s8, sm8, MAX_LEN, lin=l1, kv_cache_dtype="int8"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lf = P.shard_linear_impl(P.make_w8a8_linear_impl(lin8.payloads, mode="fused"), mesh22)
        ys = P.greedy_decode(m22, spt, s8, sm8, MAX_LEN, lin=lf, kv_cache_dtype="int8",
                             fused_attn=True)
    out["fused"] = {"mode": lf.mode, "q8": hasattr(lf, "linear_q8"),
                    "warnings": [str(w.message) for w in caught],
                    "tokens": torch.equal(ys, out["w8a8_int8_tokens"][1])}
    l4 = P.make_w4a8_linear_impl(TI.quantize_model_params_int4(m1, sp))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lt4 = P.shard_linear_impl(l4, mesh22)
    k8_widths = []
    k8 = TI.K.quant_w4a8_matmul

    def counted_k8(x, wp, sw, b=None):
        k8_widths.append(wp.shape[1])
        return k8(x, wp, sw, b)

    TI.K.quant_w4a8_matmul = counted_k8
    try:
        out["w4a8"] = _w8a8_steps(m1, m22, sp, spt, l4, lt4, s8, sm8)
    finally:
        TI.K.quant_w4a8_matmul = k8
    out["w4a8"]["warnings"] = [str(w.message) for w in caught]
    out["w4a8"]["k8_widths"] = sorted(set(k8_widths))
    out["w4a8"]["k8_calls"] = len(k8_widths)
    out["w4a8_tokens"] = (
        P.greedy_decode(m22, spt, s8, sm8, MAX_LEN, lin=lt4, kv_cache_dtype="int8"),
        P.greedy_decode(m1, sp, s8, sm8, MAX_LEN, lin=l4, kv_cache_dtype="int8"))
    out["sum_calls"] = P.parallel.model_sum.calls
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
    from onnx_transformer_tpu.ops import layers as L
    from onnx_transformer_tpu.parallel.mesh import make_mesh
    from onnx_transformer_tpu.parallel.sharding import param_pspecs, shard_params
    from onnx_transformer_tpu.serving import decode as D

    m = Transformer(TransformerConfig(src_vocab_size=31, tgt_vocab_size=29, dropout=0.0,
                                      **DIMS))
    params = m.init(jax.random.key(3))
    src = jnp.asarray(_src())
    sm = L.make_src_mask(src)
    mesh = make_mesh(data=1, model=4)
    sharded = shard_params(params, mesh)
    att = sharded["encoder"]["layers"][0]["self_attn"]
    dec = jax.jit(lambda p, s, msk: D.greedy_decode(m, p, s, msk, MAX_LEN))
    return {
        "np_params": jax.tree.map(np.asarray, params),
        "pspecs": jax.tree.map(tuple, param_pspecs(params),
                               is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
        "shapes": {(k, p): {tuple(s.data.shape) for s in att[k][p].addressable_shards}
                   for k in ("q", "o") for p in ("w", "b")},
        "one": np.array(D.greedy_decode_jit(m, params, (src, sm), MAX_LEN, 0)),
        "tp4": np.array(dec(sharded, src, sm)),
    }


@pytest.fixture(scope="module")
def world(jax_side):
    return P.launch(_world, 4, jax_side["np_params"], _src(), _src(b=4, seed=7),
                    timeout_s=600)


def test_param_pspecs_equal_jax(jax_side):
    specs = P.param_pspecs(P.params_from_jax(jax_side["np_params"], device="cpu"))
    assert specs == jax_side["pspecs"]


def test_shard_shapes_equal_jax(world, jax_side):
    assert world["shapes"]["q", "w"] == (32, 8) and world["shapes"]["o", "w"] == (8, 32)
    for key, shape in world["shapes"].items():
        assert jax_side["shapes"][key] == {shape}, key


def test_meshes_lay_out_the_world(world):
    assert world["mesh4"] == (1, 4, 0, 0) and world["mesh22"] == (2, 2, 0, 0)


def test_param_shardings_give_the_shards(world):
    assert world["dtensor_local"]


def test_tp4_greedy_equals_jax(world, jax_side):
    np.testing.assert_array_equal(jax_side["tp4"], jax_side["one"])
    np.testing.assert_array_equal(world["tp4"].numpy(), jax_side["tp4"])
    np.testing.assert_array_equal(world["one"].numpy(), jax_side["one"])


def test_every_rank_decodes_the_same_tokens(world):
    assert world["tp4_ranks_equal"]


def test_data2_model2_greedy_equals_full(world):
    assert torch.equal(world["dp2tp2"], world["one"])


def test_tp2_beam_equals_one_device(world):
    assert torch.equal(world["beam_tp"], world["beam_one"])


@pytest.mark.parametrize("mode", ["int8", "pallas"])
def test_w8a8_tp2_bit_equal_to_one_device(world, mode):
    got = world[f"w8a8_{mode}"]
    assert got["memory"] and all(got["logits"]), got
    assert got["cache"] and got["scales"] and got["cache_width"] == 16
    tp, one = world[f"w8a8_{mode}_tokens"]
    assert torch.equal(tp, one)


def test_w4a8_tp2_logits_and_cache_bit_equal_to_one_device(world):
    got = world["w4a8"]
    assert got["memory"] and all(got["logits"]), got
    assert got["cache"] and got["scales"] and got["cache_width"] == 16
    assert any("K6/K7" in w for w in got["warnings"])
    # K8 per rank: the encoder's q/k/v and w_1 (4 a layer), the cross K/V
    # (2 a decoder layer), each of 4 steps' self q/k/v, cross q and w_1 (5
    # a layer); N the rank's columns (d_model / 2, d_ff / 2)
    n = DIMS["num_layers"]
    assert got["k8_calls"] == 4 * n + 2 * n + 5 * n * 4
    assert got["k8_widths"] == [DIMS["d_model"] // 2, DIMS["d_ff"] // 2]
    tp, one = world["w4a8_tokens"]
    assert torch.equal(tp, one)


def test_w8a8_fake_tp2_tokens_equal(world):
    tp, one = world["w8a8_fake_tokens"]
    assert torch.equal(tp, one)


def test_fused_and_fused_attn_fall_back_with_a_warning(world):
    fused = world["fused"]
    assert fused["mode"] == "pallas" and not fused["q8"] and fused["tokens"]
    assert any("'fused'" in w for w in fused["warnings"])
    assert any("fused_attn" in w for w in fused["warnings"])
    assert world["sum_calls"] > 0


class _FakeMesh:
    """The attributes of a Mesh that the slicing reads."""

    def __init__(self, model, model_rank):
        self.model, self.model_rank, self.device = model, model_rank, torch.device("cpu")


def test_shard_payloads_slices_by_kind():
    cfg = P.TransformerConfig(31, 29, **DIMS)
    model = P.Transformer(cfg)
    params = model.init(seed=2, device="cpu")
    pay = TW.quantize_model_params(model, params, include_generator=True)
    mesh = _FakeMesh(2, 1)
    got = P.shard_payloads(pay, mesh)
    col, row = "decoder.layers.1.src_attn.linears.2", "encoder.layers.0.feed_forward.w_2"
    assert torch.equal(got[col]["wq"], pay[col]["wq"][:, 16:])
    assert torch.equal(got[col]["sw"], pay[col]["sw"][16:])
    assert torch.equal(got[col]["b"], pay[col]["b"][16:])
    assert torch.equal(got[row]["wq"], pay[row]["wq"][32:])
    assert torch.equal(got[row]["sw"], pay[row]["sw"]) and torch.equal(got[row]["b"],
                                                                       pay[row]["b"])
    assert got["generator.proj"]["wq"] is pay["generator.proj"]["wq"]
    assert [TS.linear_kind(n) for n in ("encoder.layers.0.self_attn.linears.0",
                                        "encoder.layers.0.self_attn.linears.3",
                                        "decoder.layers.0.feed_forward.w_1",
                                        "generator.proj")] == ["column", "row", "column",
                                                               "replicated"]
    with pytest.raises(ValueError, match="only W8A8 payloads"):
        P.shard_payloads({col: {"wq": pay[col]["wq"], "sw": 0}}, mesh)


def test_shard_payloads_slices_packed_int4():
    """W4A8 payloads: column-parallel packed columns, row-parallel whole
    packed row pairs (rank 1 of 2 holds unpacked rows 32-63 of w_2's 64),
    the rest whole; an odd K / model is refused."""
    cfg = P.TransformerConfig(31, 29, **DIMS)
    model = P.Transformer(cfg)
    pay = TI.quantize_model_params_int4(model, model.init(seed=2, device="cpu"))
    got = P.shard_payloads(pay, _FakeMesh(2, 1))
    col, row = "decoder.layers.1.src_attn.linears.2", "encoder.layers.0.feed_forward.w_2"
    assert torch.equal(got[col]["wq_packed"], pay[col]["wq_packed"][:, 16:])
    assert torch.equal(got[col]["sw"], pay[col]["sw"][16:])
    assert torch.equal(got[col]["b"], pay[col]["b"][16:])
    assert torch.equal(got[row]["wq_packed"], pay[row]["wq_packed"][16:])
    assert torch.equal(TQ.unpack_int4(got[row]["wq_packed"]),
                       TQ.unpack_int4(pay[row]["wq_packed"])[32:])
    assert torch.equal(got[row]["sw"], pay[row]["sw"]) and torch.equal(got[row]["b"],
                                                                       pay[row]["b"])
    odd = "encoder.layers.0.self_attn.linears.3"     # K = 32: 16 packed rows
    with pytest.raises(ValueError, match="K / model must be even"):
        P.shard_payloads({odd: pay[odd]}, _FakeMesh(32, 0))


def test_tp_needs_heads_and_d_ff_divisible():
    cfg = P.TransformerConfig(31, 29, **DIMS)
    with pytest.raises(ValueError, match="divisible by the model axis, 3"):
        P.Transformer(cfg, _FakeMesh(3, 0))
    assert P.Transformer(cfg, _FakeMesh(2, 0)).heads == 2


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        P.make_mesh(model=2, device="cpu")
    assert PM.initialize_distributed(num_processes=1) is None and not dist.is_initialized()


def _fail_on_rank_1(pid_dir):
    with open(os.path.join(pid_dir, f"{dist.get_rank()}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()     # rank 0 waits here for a rank that never comes


def test_launch_reraises_a_rank_error_and_kills_every_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as info:
        P.launch(_fail_on_rank_1, 2, str(tmp_path), timeout_s=120)
    assert time.monotonic() - t0 < 100
    # rank 1's traceback comes first, whichever rank the join saw first
    assert str(info.value).index("-- rank 1 raised:\nTraceback") == str(info.value).index(
        "-- rank ")
    for rank in (0, 1):
        pid = int((tmp_path / f"{rank}.pid").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
