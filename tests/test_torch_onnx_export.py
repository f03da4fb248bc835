"""Port of export/onnx_qdq.py and export/onnx_proto.py against the JAX package.

- ``build_encoder_graph`` / ``build_decoder_graph`` emit the JAX package's
  bytes exactly, with and without static activation scales, on the same
  params carried across with ``params_from_jax`` and each package's own
  W8A8 payloads (vocabularies 37/31, 2 layers, d_model 32, 4 heads, as
  tests/test_onnx_export.py's).
- The wire format round-trips tensors and every attribute type.
- The emitted graphs, re-parsed and run by a numpy node interpreter (a copy
  of tests/test_onnx_export.py:20-92), agree with the port's encoder and
  decoder layers under the weight-QDQ arithmetic (atol 2e-4, rtol 1e-4, the
  JAX test's bound), the decoder at two target lengths and batch sizes.
"""

import jax
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.export import onnx_proto as JP
from onnx_transformer_tpu.export import onnx_qdq as JQ
from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.export import onnx_proto as P
from onnx_transformer_tpu_torch.export import onnx_qdq as TQ
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.quant import core as Q
from onnx_transformer_tpu_torch.quant import w8a8 as TW


def run_graph(g: P.PGraph, feeds: dict) -> dict:
    """Numpy node-by-node interpreter for the op set the exporter emits."""
    env = dict(g.initializers)
    env.update(feeds)

    def axes_of(node):
        return tuple(node.attrs.get("axes", [-1]))

    for node in g.nodes:
        i = [env[x] for x in node.inputs]
        op = node.op_type
        if op == "MatMul":
            o = i[0].astype(np.float32) @ i[1].astype(np.float32)
        elif op == "Add":
            o = i[0] + i[1]
        elif op == "Sub":
            o = i[0] - i[1]
        elif op == "Mul":
            o = i[0] * i[1]
        elif op == "Div":
            o = i[0] / i[1]
        elif op == "Sqrt":
            o = np.sqrt(i[0])
        elif op == "Relu":
            o = np.maximum(i[0], 0)
        elif op == "Round":
            # ONNX Round is round-half-to-even, like np.round
            o = np.round(i[0])
        elif op == "Identity":
            o = i[0]
        elif op == "ReduceMean":
            o = np.mean(i[0], axis=axes_of(node),
                        keepdims=bool(node.attrs.get("keepdims", 1)))
        elif op == "Softmax":
            ax = node.attrs.get("axis", -1)
            m = i[0] - np.max(i[0], axis=ax, keepdims=True)
            e = np.exp(m)
            o = e / np.sum(e, axis=ax, keepdims=True)
        elif op == "Transpose":
            o = np.transpose(i[0], node.attrs["perm"])
        elif op == "Reshape":
            shape = [i[0].shape[k] if s == 0 else int(s)
                     for k, s in enumerate(i[1])]
            o = i[0].reshape(shape)
        elif op == "Where":
            o = np.where(i[0], i[1], i[2])
        elif op == "DequantizeLinear":
            axis = node.attrs.get("axis", 1)
            scale = i[1]
            shape = [1] * i[0].ndim
            if scale.ndim:
                shape[axis] = scale.shape[0]
            o = (i[0].astype(np.float32) - i[2].astype(np.float32).reshape(
                shape)) * scale.reshape(shape)
        elif op == "QuantizeLinear":
            axis = node.attrs.get("axis", 1)
            scale = i[1]
            shape = [1] * i[0].ndim
            if scale.ndim:
                shape[axis] = scale.shape[0]
            o = np.clip(
                np.round(i[0] / scale.reshape(shape))
                + i[2].astype(np.float32).reshape(shape),
                -128, 127).astype(np.int8)
        else:
            raise NotImplementedError(op)
        env[node.outputs[0]] = np.asarray(o, np.float32) \
            if np.asarray(o).dtype == np.float64 else np.asarray(o)
    return {name: env[name] for name in g.outputs}


@pytest.fixture(scope="module")
def models():
    cfg = TransformerConfig(src_vocab_size=37, tgt_vocab_size=31, num_layers=2, d_model=32,
                            d_ff=64, num_heads=4, dropout=0.0)
    m = Transformer(cfg)
    params = m.init(jax.random.key(9))
    pm = PT.Transformer(PT.TransformerConfig(37, 31, num_layers=2, d_model=32, d_ff=64,
                                             num_heads=4))
    pp = params_from_jax(params, device="cpu")
    rng = np.random.default_rng(7)
    jpay = JW.quantize_model_params(m, params)
    act_scales = {name: np.abs(rng.normal(1.0, 0.2, np.asarray(p["wq"]).shape[0]))
                  .astype(np.float32) for name, p in jpay.items()}
    return m, params, jpay, pm, pp, TW.quantize_model_params(pm, pp), act_scales


@pytest.mark.parametrize("graph", ["encoder", "decoder"])
@pytest.mark.parametrize("with_scales", [False, True], ids=["weight-QDQ", "QCDQ"])
def test_graph_bytes_equal_jax(models, graph, with_scales):
    m, params, jpay, pm, pp, tpay, act_scales = models
    j = getattr(JQ, f"build_{graph}_graph")
    t = getattr(TQ, f"build_{graph}_graph")
    scales = act_scales if with_scales else None
    tscales = ({k: torch.from_numpy(v) for k, v in act_scales.items()}
               if with_scales else None)
    assert t(pm, pp, tpay, tscales) == j(m, params, jpay, scales)


def test_export_qdq_onnx_writes_the_jax_files(models, tmp_path):
    m, params, jpay, pm, pp, tpay, act_scales = models
    jpaths = JQ.export_qdq_onnx(m, params, jpay, str(tmp_path / "jax"), act_scales)
    tpaths = TQ.export_qdq_onnx(pm, pp, tpay, str(tmp_path / "torch"), act_scales)
    assert sorted(tpaths) == sorted(jpaths) == ["decoder", "encoder"]
    for name in jpaths:
        with open(jpaths[name], "rb") as a, open(tpaths[name], "rb") as b:
            assert a.read() == b.read()


def test_proto_module_is_a_copy():
    for name in ("tensor_proto", "node_proto", "value_info", "graph_proto", "model_proto",
                 "parse_model", "parse_tensor"):
        assert hasattr(P, name)
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert P.tensor_proto("x", arr) == JP.tensor_proto("x", arr)
    node = dict(axis=1, perm=[0, 2, 1], alpha=0.5, mode="x", floats=[1.0, 2.0],
                value=np.ones(3, np.int64))
    assert P.node_proto("Op", ["a"], ["b"], name="n", **node) == JP.node_proto(
        "Op", ["a"], ["b"], name="n", **node)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.float32, np.int32, np.int64, np.bool_])
def test_wire_format_roundtrip_tensor(dtype):
    arr = (np.arange(24).reshape(4, 6) - 7).astype(dtype)
    name, back = P.parse_tensor(P.tensor_proto("w", arr))
    assert name == "w" and back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)


def test_wire_format_roundtrip_attributes():
    attrs = dict(i=-3, f=0.25, s="abc", ints=[0, -1, 7], floats=[0.5, -2.0],
                 t=np.arange(4, dtype=np.int64))
    g = P.graph_proto("G", [P.node_proto("Op", ["a"], ["b"], name="n", **attrs)], [],
                      [P.value_info("a", P.F32, ["batch", 3])],
                      [P.value_info("b", P.F32, ["batch", 3])])
    parsed = P.parse_model(P.model_proto(g))
    got = parsed.nodes[0].attrs
    assert got["i"] == -3 and got["f"] == 0.25 and got["s"] == "abc"
    assert got["ints"] == [0, -1, 7] and got["floats"] == [0.5, -2.0]
    np.testing.assert_array_equal(got["t"], attrs["t"])
    assert parsed.inputs == ["a"] and parsed.outputs == ["b"]


def _wqdq_lin(payloads):
    """The exported graph's arithmetic in the port: dequantized int8
    weights, fp activations."""
    def lin(name, x, w, b, taps=None, inject=None):
        p = payloads.get(name)
        if p is None:
            return PT.default_linear(name, x, w, b, taps, inject)
        return TL.linear(x, Q.dequantize(p["wq"], p["sw"][None, :]), p["b"])
    return lin


def _port_encoder(pm, pp, x, mask, lin):
    """``encode`` minus the embedding (the graph takes embedded input)."""
    for i, lp in enumerate(pp["encoder"]["layers"]):
        x = pm._encoder_layer(lp, x, mask, None, False, None, None, lin, f"encoder.layers.{i}")
    ln = pp["encoder"]["ln"]
    return TL.layer_norm(x, ln["scale"], ln["bias"])


def _port_decoder(pm, pp, ys, memory, tmask, smask, lin):
    """``decode`` minus the embedding."""
    x = ys
    for i, lp in enumerate(pp["decoder"]["layers"]):
        x = pm._decoder_layer(lp, x, memory, tmask, smask, None, False, None, None, lin,
                              f"decoder.layers.{i}")
    ln = pp["decoder"]["ln"]
    return TL.layer_norm(x, ln["scale"], ln["bias"])


def test_encoder_graph_runs_as_the_port_encoder(models):
    m, params, jpay, pm, pp, tpay, _ = models
    g = P.parse_model(TQ.build_encoder_graph(pm, pp, tpay))
    assert g.inputs == ["global_in", "global_in_1"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    mask = np.ones((3, 1, 1, 7), bool)
    mask[1, :, :, -2:] = False
    out = run_graph(g, {"global_in": x, "global_in_1": mask})["global_out"]
    want = _port_encoder(pm, pp, torch.from_numpy(x), torch.from_numpy(mask), _wqdq_lin(tpay))
    np.testing.assert_allclose(out, want.numpy(), atol=2e-4, rtol=1e-4)


def test_decoder_graph_runs_as_the_port_decoder_at_two_lengths(models):
    m, params, jpay, pm, pp, tpay, _ = models
    raw = TQ.build_decoder_graph(pm, pp, tpay)
    assert b"tgt" in raw and b"batch" in raw
    g = P.parse_model(raw)
    rng = np.random.default_rng(3)
    for b, s, t in ((2, 6, 5), (3, 4, 9)):
        ys = rng.normal(size=(b, t, 32)).astype(np.float32)
        memory = rng.normal(size=(b, s, 32)).astype(np.float32)
        smask = np.ones((b, 1, 1, s), bool)
        smask[0, :, :, -1] = False
        tmask = np.tril(np.ones((t, t), bool))[None, None].repeat(b, 0)
        out = run_graph(g, {"ys_embed": ys, "memory": memory, "src_mask": smask,
                            "tgt_mask": tmask})["global_out"]
        want = _port_decoder(pm, pp, torch.from_numpy(ys), torch.from_numpy(memory),
                             torch.from_numpy(tmask), torch.from_numpy(smask), _wqdq_lin(tpay))
        assert out.shape == (b, t, 32)
        np.testing.assert_allclose(out, want.numpy(), atol=2e-4, rtol=1e-4)
