"""QDQ ONNX export (port of ``onnx_transformer_tpu/export/onnx_qdq.py``).

Emits ``encoder.onnx`` and ``decoder.onnx`` mirroring the reference's
two-artifact layout (``encoder_decoder.py:31-52``): the encoder graph takes
the EMBEDDED source + source mask; the decoder graph takes the embedded
target prefix, encoder memory, and both masks, and returns the decoder
hidden states (the generator runs outside the graph, as in the reference's
decode loop).

Quantization in the graph is weight-QDQ: per-out-channel int8 weights as
initializers + ``DequantizeLinear`` feeding fp ``MatMul``, and the
attention-prob 1/127 fake-quant emitted literally (Mul 127 / Round / Div
127).  ``act_scales`` (the calibrated per-channel absmax dict of
``quant.calibrate`` or the reference artifact) additionally emits a static
per-tensor activation QCDQ pair (``max(absmax)/127``) in front of every
quantized MatMul.  Graph I/O shapes use symbolic ``dim_param`` axes, so one
decoder graph runs at any target length.

The port's params and ``quant.w8a8.quantize_model_params`` payloads are
tensors; they become numpy arrays at this boundary, and for the same values
the emitted bytes equal the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

import torch

from onnx_transformer_tpu_torch.export import onnx_proto as P
from onnx_transformer_tpu_torch.models.transformer import Transformer


def _np(x, dtype) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class _GraphBuilder:
    def __init__(self, act_scales: dict | None = None):
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self.act_scales = act_scales or {}
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init_tensor(self, name: str, arr: np.ndarray) -> str:
        self.inits.append(P.tensor_proto(name, np.ascontiguousarray(arr)))
        return name

    def n(self, op: str, inputs, out_hint: str = "t", **attrs) -> str:
        out = self.fresh(out_hint)
        self.nodes.append(P.node_proto(op, inputs, [out],
                                       name=self.fresh(op), **attrs))
        return out

    def n_named(self, op: str, inputs, output: str, **attrs) -> str:
        self.nodes.append(P.node_proto(op, inputs, [output],
                                       name=self.fresh(op), **attrs))
        return output


def _const(g: _GraphBuilder, value, dtype=np.float32, hint="c") -> str:
    return g.init_tensor(g.fresh(hint), np.asarray(value, dtype))


def _qdq_linear(g: _GraphBuilder, x: str, name: str, payloads: dict) -> str:
    """int8 weight initializer + DequantizeLinear (per-out-channel) +
    MatMul + bias Add — the QDQ pattern any ORT quantizer recognises.
    When the builder carries calibrated ``act_scales``, a static
    per-tensor activation QCDQ pair is emitted in front of the MatMul."""
    p = payloads[name]
    if name in g.act_scales:
        sa = float(np.max(_np(g.act_scales[name], np.float32)) / 127.0)
        sa = max(sa, 1e-5)                 # quant_linear.py:30 scale floor
        s_init = _const(g, sa, np.float32, f"{name}.act_scale".replace(".", "_"))
        zp = _const(g, 0, np.int8, "act_zp")
        xq = g.n("QuantizeLinear", [x, s_init, zp], "x_q")
        x = g.n("DequantizeLinear", [xq, s_init, zp], "x_dq")
    wq = g.init_tensor(f"{name}.weight_q", _np(p["wq"], np.int8))
    sw = g.init_tensor(f"{name}.weight_scale", _np(p["sw"], np.float32))
    zp = g.init_tensor(f"{name}.weight_zp",
                       np.zeros(tuple(p["sw"].shape), np.int8))
    wf = g.n("DequantizeLinear", [wq, sw, zp], "w_dq", axis=1)
    y = g.n("MatMul", [x, wf], "mm")
    b = g.init_tensor(f"{name}.bias", _np(p["b"], np.float32))
    return g.n("Add", [y, b], "lin")


def _layer_norm(g: _GraphBuilder, x: str, scale, bias, nm: str, eps: float = 1e-6) -> str:
    """The reference's ddof-1 LayerNorm with eps on the STD
    (layer_norm.py:12-15), decomposed into standard ONNX ops."""
    d = scale.shape[-1]
    mu = g.n("ReduceMean", [x], "mu", axes=[-1], keepdims=1)
    xc = g.n("Sub", [x, mu], "xc")
    sq = g.n("Mul", [xc, xc], "sq")
    # ddof-1 variance as ReduceMean * d/(d-1): ReduceSum moved its axes to
    # an input at opset 13 while ReduceMean keeps the attribute — one op
    # convention for every reducer in the graph
    ms = g.n("ReduceMean", [sq], "ms", axes=[-1], keepdims=1)
    var = g.n("Mul", [ms, _const(g, d / (d - 1))], "var")
    std = g.n("Sqrt", [var], "std")
    den = g.n("Add", [std, _const(g, eps)], "den")
    xn = g.n("Div", [xc, den], "xn")
    sc = g.init_tensor(f"{nm}.a_2", _np(scale, np.float32))
    bi = g.init_tensor(f"{nm}.b_2", _np(bias, np.float32))
    return g.n("Add", [g.n("Mul", [xn, sc], "xs"), bi], "ln")


def _split_heads(g: _GraphBuilder, x: str, h: int, dk: int) -> str:
    r = g.n("Reshape", [x, _const(g, [0, 0, h, dk], np.int64, "shp")], "rh")
    return g.n("Transpose", [r], "th", perm=[0, 2, 1, 3])


def _attention(g: _GraphBuilder, q_in: str, kv_in: str, mask: str,
               nm: str, payloads: dict, h: int, d: int,
               quantize_probs: bool) -> str:
    dk = d // h
    q = _split_heads(g, _qdq_linear(g, q_in, f"{nm}.linears.0", payloads), h, dk)
    k = _split_heads(g, _qdq_linear(g, kv_in, f"{nm}.linears.1", payloads), h, dk)
    v = _split_heads(g, _qdq_linear(g, kv_in, f"{nm}.linears.2", payloads), h, dk)
    kt = g.n("Transpose", [k], "kt", perm=[0, 1, 3, 2])
    scores = g.n("MatMul", [q, kt], "scores")
    scores = g.n("Div", [scores, _const(g, float(np.sqrt(dk)))], "scaled")
    masked = g.n("Where", [mask, scores, _const(g, -1e9)], "masked")
    probs = g.n("Softmax", [masked], "probs", axis=-1)
    if quantize_probs:
        probs = g.n("Div", [
            g.n("Round", [g.n("Mul", [probs, _const(g, 127.0)], "p127")],
                "pround"),
            _const(g, 127.0)], "pq")
    ctx = g.n("MatMul", [probs, v], "ctx")
    ctx = g.n("Transpose", [ctx], "ctxt", perm=[0, 2, 1, 3])
    merged = g.n("Reshape", [ctx, _const(g, [0, 0, d], np.int64, "shp")], "mrg")
    return _qdq_linear(g, merged, f"{nm}.linears.3", payloads)


def _ffn(g: _GraphBuilder, x: str, nm: str, payloads: dict) -> str:
    hcur = g.n("Relu", [_qdq_linear(g, x, f"{nm}.w_1", payloads)], "relu")
    return _qdq_linear(g, hcur, f"{nm}.w_2", payloads)


def _sublayer(g, x, ln_p, nm, fn):
    y = fn(_layer_norm(g, x, ln_p["scale"], ln_p["bias"], nm))
    return g.n("Add", [x, y], "res")


def build_encoder_graph(model: Transformer, params, payloads: dict,
                        act_scales: dict | None = None) -> bytes:
    cfg = model.cfg
    g = _GraphBuilder(act_scales)
    x = "global_in"                       # embedded source [B, S, D]
    for i, lp in enumerate(params["encoder"]["layers"]):
        nm = f"encoder.layers.{i}"
        x = _sublayer(g, x, lp["ln0"], f"{nm}.sublayer.0.norm",
                      lambda h: _attention(g, h, h, "global_in_1",
                                           f"{nm}.self_attn", payloads,
                                           cfg.num_heads, cfg.d_model,
                                           cfg.quantize_attn_probs))
        x = _sublayer(g, x, lp["ln1"], f"{nm}.sublayer.1.norm",
                      lambda h: _ffn(g, h, f"{nm}.feed_forward", payloads))
    ln = params["encoder"]["ln"]
    out = _layer_norm(g, x, ln["scale"], ln["bias"], "encoder.norm")
    g.nodes.append(P.node_proto("Identity", [out], ["global_out"]))
    graph = P.graph_proto(
        "Encoder", g.nodes, g.inits,
        inputs=[P.value_info("global_in", P.F32, ["batch", "src", cfg.d_model]),
                P.value_info("global_in_1", P.BOOL, ["batch", 1, 1, "src"])],
        outputs=[P.value_info("global_out", P.F32,
                              ["batch", "src", cfg.d_model])],
    )
    return P.model_proto(graph)


def build_decoder_graph(model: Transformer, params, payloads: dict,
                        act_scales: dict | None = None) -> bytes:
    cfg = model.cfg
    g = _GraphBuilder(act_scales)
    x = "ys_embed"                        # embedded target prefix [B, T, D]
    for i, lp in enumerate(params["decoder"]["layers"]):
        nm = f"decoder.layers.{i}"
        x = _sublayer(g, x, lp["ln0"], f"{nm}.sublayer.0.norm",
                      lambda h: _attention(g, h, h, "tgt_mask",
                                           f"{nm}.self_attn", payloads,
                                           cfg.num_heads, cfg.d_model,
                                           cfg.quantize_attn_probs))
        x = _sublayer(g, x, lp["ln1"], f"{nm}.sublayer.1.norm",
                      lambda h: _attention(g, h, "memory", "src_mask",
                                           f"{nm}.src_attn", payloads,
                                           cfg.num_heads, cfg.d_model,
                                           cfg.quantize_attn_probs))
        x = _sublayer(g, x, lp["ln2"], f"{nm}.sublayer.2.norm",
                      lambda h: _ffn(g, h, f"{nm}.feed_forward", payloads))
    ln = params["decoder"]["ln"]
    out = _layer_norm(g, x, ln["scale"], ln["bias"], "decoder.norm")
    g.nodes.append(P.node_proto("Identity", [out], ["global_out"]))
    graph = P.graph_proto(
        "Decoder", g.nodes, g.inits,
        inputs=[P.value_info("ys_embed", P.F32, ["batch", "tgt", cfg.d_model]),
                P.value_info("memory", P.F32, ["batch", "src", cfg.d_model]),
                P.value_info("src_mask", P.BOOL, ["batch", 1, 1, "src"]),
                P.value_info("tgt_mask", P.BOOL, ["batch", 1, "tgt", "tgt"])],
        outputs=[P.value_info("global_out", P.F32,
                              ["batch", "tgt", cfg.d_model])],
    )
    return P.model_proto(graph)


def export_qdq_onnx(model: Transformer, params, payloads: dict,
                    out_dir: str, act_scales: dict | None = None) -> dict:
    """Write encoder.onnx + decoder.onnx; returns {name: path}.
    ``act_scales``: opt-in static activation QCDQ (see module docstring)."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, builder in (("encoder", build_encoder_graph),
                          ("decoder", build_decoder_graph)):
        path = os.path.join(out_dir, f"{name}.onnx")
        with open(path, "wb") as f:
            f.write(builder(model, params, payloads, act_scales))
        out[name] = path
    return out
