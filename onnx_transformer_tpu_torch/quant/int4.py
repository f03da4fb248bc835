"""W4A8 deployment and QAT linears (port of ``onnx_transformer_tpu/quant/int4.py``).

- ``make_qat_linear_impl``: fake-quantizes the weights to ``w_bits``
  (per out-channel) and the activations to ``a_bits`` (per token) with
  straight-through rounding, a differentiable stand-in for every linear of
  the training forward.
- ``quantize_model_params_int4``: per-channel int4 weights stored as packed
  nibbles, two to a byte (``quant.core.pack_int4``).
- ``make_w4a8_linear_impl``: the deployed linears.  The q/k/v projections of
  at least ``quant.w8a8.FUSED_MIN_TOKENS`` tokens go to kernel K6
  (``quant_w4a8_matmul_qout``), which unpacks the nibbles on the card, and
  ``lin.linear_q8`` gives the cross-K/V producer K7
  (``quant_w4a8_matmul_q8``); every other call unpacks the weights and runs
  the int8 chain.

Both impls take the reference's ``taps`` and ``inject`` and tap its sites
(input, ``.x_q``, ``.w_q``, ``.out``); with either given, the W4A8 impl runs
the int8 chain instead of K6.

The JAX package's ``lin.rebind`` hands payloads through a jit boundary; the
port runs eagerly and has no counterpart.
"""

from __future__ import annotations

from typing import Callable

import torch

from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K
from onnx_transformer_tpu_torch.quant import core as Q
from onnx_transformer_tpu_torch.quant import w8a8 as W8
from onnx_transformer_tpu_torch.quant.w8a8 import (
    _param_leaf,
    is_quantized_output,
    quantized_linear_names,
)


def make_qat_linear_impl(w_bits: int = 4, a_bits: int = 8) -> Callable:
    """Differentiable fake-quant linear for QAT (straight-through gradients).
    The generator gets weight-only fake-quant; linears other than the
    attention projections and the FFN stay fp."""

    def lin(name: str, x, w, b, taps: L.TapDict = None, inject: L.InjectDict = None):
        if name == "generator.proj":
            wq = Q.fake_quant_ste(w, Q.absmax_scale(w, axis=0, bits=w_bits), w_bits)
            return L.tap(name + ".out", L.linear(L.tap(name, x, taps, inject), wq, b),
                         taps, inject)
        if ".linears." not in name and "feed_forward" not in name:
            return default_linear(name, x, w, b, taps, inject)
        x = L.tap(name, x, taps, inject)
        xq = Q.fake_quant_ste(x, Q.act_scale_per_token(x, a_bits), a_bits)
        wq = Q.fake_quant_ste(w, Q.absmax_scale(w, axis=0, bits=w_bits), w_bits)
        y = L.tap(name + ".out", L.linear(xq, wq, b), taps, inject)
        if is_quantized_output(name):
            y = Q.fake_quant_ste(y, Q.act_scale_per_token(y, a_bits), a_bits)
        return y

    return lin


def quantize_model_params_int4(model: Transformer, params: dict) -> dict:
    """name -> {wq_packed uint8 [in // 2, out], sw f32 [out], b f32 [out]}."""
    payloads = {}
    for name in quantized_linear_names(model.cfg.num_layers):
        leaf = _param_leaf(params, name)
        w = leaf["w"].float()
        sw = Q.absmax_scale(w, axis=0, bits=4, keepdims=False)
        wq = Q.quantize(w, sw[None, :], bits=4, clip=True)
        payloads[name] = {"wq_packed": Q.pack_int4(wq).contiguous(), "sw": sw,
                          "b": leaf["b"].float()}
    return payloads


def _tokens(x: torch.Tensor) -> int:
    return x[..., 0].numel()


def _k6_ok(p: dict, name: str, x: torch.Tensor, a_bits: int, taps: L.TapDict = None,
           inject: L.InjectDict = None) -> bool:
    """K6 takes the q/k/v projections of big calls without taps or inject.
    The JAX package admits K <= 4096 here, which its kernel then refuses
    above 2048; the port gates on the kernel's own K, N <= 2048."""
    n = p["wq_packed"].shape[-1]
    return (a_bits == 8 and taps is None and inject is None and is_quantized_output(name)
            and _tokens(x) >= W8.FUSED_MIN_TOKENS
            and x.shape[-1] <= K.MAX_KN and n <= K.MAX_KN and n % min(512, n) == 0)


def make_w4a8_linear_impl(payloads: dict, a_bits: int = 8, fused: bool = True) -> Callable:
    """LinearImpl over packed-int4 weights and ``a_bits`` activations.
    ``FUSED_MIN_TOKENS`` is read from ``quant.w8a8`` at call time."""

    def lin(name: str, x, w, b, taps: L.TapDict = None, inject: L.InjectDict = None):
        p = payloads.get(name)
        if p is None:
            return default_linear(name, x, w, b, taps, inject)
        if fused and _k6_ok(p, name, x, a_bits, taps, inject):
            return K.quant_w4a8_matmul_qout(x, p["wq_packed"], p["sw"], p["b"])
        x = L.tap(name, x, taps, inject)
        sx = Q.act_scale_per_token(x, a_bits)
        xq = L.tap(f"{name}.x_q", Q.quantize(x, sx, a_bits), taps, inject)
        # int4 values in int8 [in, out]
        wq = L.tap(f"{name}.w_q", Q.unpack_int4(p["wq_packed"]), taps, inject)
        y = K.w8a8_matmul_ref(xq.reshape(-1, xq.shape[-1]), sx.reshape(-1), wq, p["sw"],
                              p["b"]).reshape(*x.shape[:-1], -1)
        y = L.tap(f"{name}.out", y, taps, inject)
        if is_quantized_output(name):
            y = Q.fake_quant_act_per_token(y, a_bits)
        return y

    if fused:
        def linear_q8(name, x, w=None, b=None):
            """(int8 rows, per-token scales) straight from kernel K7, or
            None when the call cannot take the kernel."""
            p = payloads.get(name)
            if (p is None or not is_quantized_output(name) or a_bits != 8
                    or _tokens(x) < W8.FUSED_MIN_TOKENS
                    or x.shape[-1] > K.MAX_KN or p["wq_packed"].shape[-1] > K.MAX_KN):
                return None
            return K.quant_w4a8_matmul_q8(x, p["wq_packed"], p["sw"], p["b"])

        lin.linear_q8 = linear_q8
    lin.payloads = payloads
    # q/k/v outputs sit exactly on the per-token int8 grid (see quant/w8a8.py)
    lin.quantized_output_grid = True
    return lin
