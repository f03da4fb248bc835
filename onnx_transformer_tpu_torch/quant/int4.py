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
the int8 chain instead of K6.  Both take ``mesh=`` for the tensor-parallel
view (``Transformer(cfg, mesh=mesh)``): the W4A8 impl over this rank's
packed payload slices (``parallel.shard_payloads``), where K6/K7 step aside
for kernel K8 (``quant_w4a8_matmul``) on the column-parallel linears and
the plain chain on the row-parallel ones, and the QAT impl for training over a mesh
(``quant.w8a8.shard_linear_impl`` makes either from a one-device impl).

The JAX package's ``lin.rebind`` hands payloads through a jit boundary; the
port runs eagerly and has no counterpart.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K
from onnx_transformer_tpu_torch.parallel.collectives import model_sum
from onnx_transformer_tpu_torch.parallel.sharding import linear_kind, shard_payloads
from onnx_transformer_tpu_torch.quant import core as Q
from onnx_transformer_tpu_torch.quant import w8a8 as W8
from onnx_transformer_tpu_torch.quant.w8a8 import (
    _param_leaf,
    is_quantized_output,
    quantized_linear_names,
)


def make_qat_linear_impl(w_bits: int = 4, a_bits: int = 8, mesh=None) -> Callable:
    """Differentiable fake-quant linear for QAT (straight-through gradients).
    The generator gets weight-only fake-quant; linears other than the
    attention projections and the FFN stay fp.

    With a ``mesh``, for the tensor-parallel view ``Transformer(cfg,
    mesh=mesh)``: every scale is the whole row's or column's, as GSPMD
    gives the JAX package's impl.  A row-parallel linear (out-projection,
    ``w_2``) takes its input's per-token scale and its weight's per-column
    scale (over the sharded K) as maxima over the model group, and sums
    its partial product over the group before the bias; a column-parallel
    q/k/v output takes its per-token scale over the group.  The gradient
    passes through each maximum and splits at a tie across the group as
    ``jax.grad``'s does (``quant.core.sharded_absmax``)."""

    def lin(name: str, x, w, b, taps: L.TapDict = None, inject: L.InjectDict = None):
        if name == "generator.proj":
            wq = Q.fake_quant_ste(w, Q.absmax_scale(w, axis=0, bits=w_bits), w_bits)
            return L.tap(name + ".out", L.linear(L.tap(name, x, taps, inject), wq, b),
                         taps, inject)
        if ".linears." not in name and "feed_forward" not in name:
            return default_linear(name, x, w, b, taps, inject)
        row = mesh if mesh is not None and linear_kind(name) == "row" else None
        x = L.tap(name, x, taps, inject)
        xq = Q.fake_quant_ste(x, Q.act_scale_per_token(x, a_bits, row), a_bits)
        wq = Q.fake_quant_ste(w, Q.sharded_absmax_scale(w, 0, w_bits, row), w_bits)
        if row is None:
            y = L.linear(xq, wq, b)
        else:
            y = model_sum(L.linear(xq, wq, None), mesh) + b
        y = L.tap(name + ".out", y, taps, inject)
        if is_quantized_output(name):
            y = Q.fake_quant_ste(y, Q.act_scale_per_token(y, a_bits, mesh), a_bits)
        return y

    lin.mesh = mesh
    lin.shard = lambda m: make_qat_linear_impl(w_bits, a_bits, m)
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


def make_w4a8_linear_impl(payloads: dict, a_bits: int = 8, fused: bool = True,
                          mesh=None) -> Callable:
    """LinearImpl over packed-int4 weights and ``a_bits`` activations.
    ``FUSED_MIN_TOKENS`` is read from ``quant.w8a8`` at call time.

    With a ``mesh``, for the tensor-parallel view ``Transformer(cfg,
    mesh=mesh)`` over this rank's payload slices (``parallel.shard_payloads``),
    as ``make_w8a8_linear_impl(..., mesh=mesh)`` is: a row-parallel linear
    quantizes its columns of the input with the whole row's scale, sums its
    int32 partial product over the model group (exact), then applies the
    epilogue with the bias once; the q/k/v outputs take the whole row's
    scale.  K6 and K7 quantize each output row whole, of which a
    column-parallel rank holds only part, so under a mesh they step aside
    (with a warning).  A column-parallel linear's input is whole on every
    rank, so its output columns come exactly from kernel K8
    (``quant_w4a8_matmul``, the plain chain's own product), and a q/k/v
    output then takes the whole row's scale; the row-parallel linears run
    the plain chain."""
    k8 = mesh is not None and fused
    if k8:
        warnings.warn("W4A8 kernels K6/K7 quantize each output row whole, and under a "
                      "tensor-parallel mesh a rank holds part of the row: running K8 on the "
                      "column-parallel linears and the plain chain on the row-parallel ones "
                      "instead", stacklevel=2)
        fused = False

    def lin(name: str, x, w, b, taps: L.TapDict = None, inject: L.InjectDict = None):
        p = payloads.get(name)
        row = mesh is not None and linear_kind(name) == "row"
        if p is None:
            if row:    # the plain row-parallel linear: partial products, then the bias
                return model_sum(default_linear(name, x, w, None, taps, inject), mesh) + b
            return default_linear(name, x, w, b, taps, inject)
        if fused and _k6_ok(p, name, x, a_bits, taps, inject):
            return K.quant_w4a8_matmul_qout(x, p["wq_packed"], p["sw"], p["b"])
        if (k8 and not row and a_bits == 8 and taps is None and inject is None
                and x.shape[-1] <= K.MAX_K_W4A8):
            y = K.quant_w4a8_matmul(x, p["wq_packed"], p["sw"], p["b"])
            return Q.fake_quant_act_per_token(y, a_bits, mesh) if is_quantized_output(name) else y
        x = L.tap(name, x, taps, inject)
        # a row-parallel input holds this rank's columns of each row
        sx = Q.act_scale_per_token(x, a_bits, mesh if row else None)
        xq = L.tap(f"{name}.x_q", Q.quantize(x, sx, a_bits), taps, inject)
        # int4 values in int8 [in, out]
        wq = L.tap(f"{name}.w_q", Q.unpack_int4(p["wq_packed"]), taps, inject)
        if row:
            acc = model_sum(K.int_mm(xq.reshape(-1, xq.shape[-1]), wq), mesh)
            y = K.w8a8_epilogue(acc, sx.reshape(-1), p["sw"], p["b"])
        else:
            y = K.w8a8_matmul_ref(xq.reshape(-1, xq.shape[-1]), sx.reshape(-1), wq, p["sw"],
                                  p["b"])
        y = L.tap(f"{name}.out", y.reshape(*x.shape[:-1], -1), taps, inject)
        if is_quantized_output(name):
            y = Q.fake_quant_act_per_token(y, a_bits, mesh)
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
    lin.mesh = mesh
    lin.shard = lambda m: make_w4a8_linear_impl(shard_payloads(payloads, m), a_bits, fused, m)
    # q/k/v outputs sit exactly on the per-token int8 grid (see quant/w8a8.py)
    lin.quantized_output_grid = True
    return lin
