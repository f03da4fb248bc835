"""W8A8 quantized linears (port of ``onnx_transformer_tpu/quant/w8a8.py``).

Per-out-channel absmax int8 weights, per-token absmax int8 activations; the
four attention projections and both FFN linears of every layer are
quantized, and q/k/v additionally re-quantize their *outputs*.  The
generator and the embeddings stay fp32 unless ``include_generator`` is set.

Modes: ``int8`` runs the quantize -> ``torch._int_mm`` -> scale chain;
``fused`` sends the q/k/v projections of at least ``FUSED_MIN_TOKENS``
tokens to kernel K1 and gives the cross-K/V producer kernel K2 as
``lin.linear_q8``.  Modes ``fake`` and ``pallas`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Literal, Optional

import torch

from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K
from onnx_transformer_tpu_torch.quant import core as Q

Mode = Literal["int8", "fused"]

# "fused" takes the kernels for calls of at least this many tokens (encoder /
# prefill shapes) and the int8 chain below it.  The value was tuned on a TPU
# and is still to be chosen again on the H100.
FUSED_MIN_TOKENS = 8192


def quantized_linear_names(num_layers: int) -> dict[str, bool]:
    """name -> quantize_output flag (True for the q/k/v projections)."""
    out: dict[str, bool] = {}
    for i in range(num_layers):
        for j in range(4):
            out[f"encoder.layers.{i}.self_attn.linears.{j}"] = j < 3
        out[f"encoder.layers.{i}.feed_forward.w_1"] = False
        out[f"encoder.layers.{i}.feed_forward.w_2"] = False
    for i in range(num_layers):
        for att in ("self_attn", "src_attn"):
            for j in range(4):
                out[f"decoder.layers.{i}.{att}.linears.{j}"] = j < 3
        out[f"decoder.layers.{i}.feed_forward.w_1"] = False
        out[f"decoder.layers.{i}.feed_forward.w_2"] = False
    return out


def _param_leaf(params: dict, name: str) -> dict:
    """Resolve a reference-style linear name to its parameter dict."""
    if name == "generator.proj":
        return params["generator"]
    parts = name.split(".")
    stack, idx = parts[0], int(parts[2])
    lp = params[stack]["layers"][idx]
    if parts[3] in ("self_attn", "src_attn"):
        key = {"0": "q", "1": "k", "2": "v", "3": "o"}[parts[5]]
        return lp[parts[3]][key]
    if parts[3] != "feed_forward":
        raise KeyError(name)
    return lp["ffn"]["w1" if parts[4] == "w_1" else "w2"]


def is_quantized_output(name: str) -> bool:
    """q/k/v projections re-quantize their output."""
    return ".linears." in name and name.rsplit(".", 1)[-1] in ("0", "1", "2")


def quantize_model_params(model: Transformer, params: dict,
                          include_generator: bool = False) -> dict:
    """name -> {wq int8 [in, out], sw f32 [out], b f32 [out]}."""
    names = dict(quantized_linear_names(model.cfg.num_layers))
    if include_generator:
        names["generator.proj"] = False
    payloads = {}
    for name in names:
        leaf = _param_leaf(params, name)
        wq, sw = Q.quantize_weight_per_channel(leaf["w"].float())
        payloads[name] = {"wq": wq.contiguous(), "sw": sw, "b": leaf["b"].float()}
    return payloads


def _fused_ok(p: dict, name: str, x: torch.Tensor) -> bool:
    return (is_quantized_output(name)
            and x[..., 0].numel() >= FUSED_MIN_TOKENS
            and x.shape[-1] <= K.MAX_KN and p["wq"].shape[-1] <= K.MAX_KN)


def make_w8a8_linear_impl(payloads: dict, mode: Mode = "int8") -> Callable:
    """LinearImpl for ``Transformer`` methods: the W8A8 stand-in for every
    quantized linear, the plain fp linear for the rest."""
    if mode not in ("int8", "fused"):
        raise ValueError(f"mode {mode!r} is not ported (int8, fused)")

    def lin(name: str, x, w, b):
        p = payloads.get(name)
        if p is None:
            return default_linear(name, x, w, b)
        if mode == "fused" and _fused_ok(p, name, x):
            return K.quant_w8a8_matmul_qout(x, p["wq"], p["sw"], p["b"])
        lead = x.shape[:-1]
        sx = Q.act_scale_per_token(x)
        xq = Q.quantize(x, sx)
        y32 = K.int_mm(xq.reshape(-1, xq.shape[-1]), p["wq"])
        y = y32.float() * (sx.reshape(-1, 1) * p["sw"][None, :])
        y = (y + p["b"]).reshape(*lead, -1)
        if is_quantized_output(name):
            y = Q.fake_quant_act_per_token(y)
        return y

    if mode == "fused":
        def linear_q8(name, x, w=None, b=None):
            """(int8 rows, per-token scales) straight from kernel K2, or
            None when the call cannot take the kernel."""
            p = payloads.get(name)
            if p is None or not _fused_ok(p, name, x):
                return None
            return K.quant_w8a8_matmul_q8(x, p["wq"], p["sw"], p["b"])

        lin.linear_q8 = linear_q8
    lin.payloads = payloads
    lin.mode = mode
    # q/k/v outputs sit exactly on the per-token int8 grid, so a decode
    # attention may recover their int8 form losslessly
    lin.quantized_output_grid = True
    return lin


def quantize_transformer(model: Transformer, params: dict,
                         act_scales: Optional[dict] = None, alpha: float = 0.5,
                         mode: Mode = "int8", include_generator: bool = False):
    """SmoothQuant-migrate with calibrated scales, then quantize.  Returns
    (smoothed_params, linear_impl)."""
    from onnx_transformer_tpu_torch.quant.smoothquant import smooth_params

    if act_scales is not None:
        params = smooth_params(params, act_scales, alpha)
    payloads = quantize_model_params(model, params, include_generator)
    return params, make_w8a8_linear_impl(payloads, mode)
