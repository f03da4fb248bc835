"""W8A8 quantized linears (port of ``onnx_transformer_tpu/quant/w8a8.py``).

Per-out-channel absmax int8 weights, per-token absmax int8 activations; the
four attention projections and both FFN linears of every layer are
quantized, and q/k/v additionally re-quantize their *outputs*.  The
generator and the embeddings stay fp32 unless ``include_generator`` is set.

Modes: ``int8`` runs the quantize -> ``torch._int_mm`` -> scale chain;
``pallas`` quantizes the activations per token and sends the int8 product
and its epilogue to kernel K5 (``w8a8_matmul``), bit-equal to ``int8``;
``fake`` is the reference arithmetic, an f32 matmul of the dequantized
operands; ``fused`` sends the q/k/v projections of at least
``FUSED_MIN_TOKENS`` tokens to kernel K1 and gives the cross-K/V producer
kernel K2 as ``lin.linear_q8``.  In every mode q/k/v fake-quantize their
output per token.

Tap sites, as in the JAX package: the input under the module name, the
quantized operands under ``.x_q`` and ``.w_q`` (so bit faults hit the integer
domain), the output under ``.out`` and, for q/k/v, the fake-quantized output
under ``.out_q``.  With taps or inject given, mode ``fused`` runs the int8
chain instead of K1, which has no seams.

Under a tensor-parallel mesh (``make_w8a8_linear_impl(..., mesh=mesh)`` over
``parallel.shard_payloads``), a column-parallel linear (q/k/v, ``w_1``)
computes this rank's output columns as one device computes them, K5 in
mode ``pallas``; a row-parallel one (out-projection, ``w_2``) quantizes its
columns of the input with the whole row's scale, sums its int32 partial
product over the model group (exact), then applies K5's plain epilogue
with the bias once, so both are bit-equal to one device; ``fake`` sums its
f32 partial products.  The q/k/v outputs take the whole row's scale.  Mode
``fused`` quantizes an output row whole inside K1/K2, of which a rank holds
only part: under a mesh it warns and runs mode ``pallas``, whose
column-parallel linears keep K5.  ``shard_linear_impl`` makes the
tensor-parallel counterpart of a one-device W8A8, W4A8 or QAT impl.

``bits`` sets the width of the weights and activations (qmax 2^(bits-1)-1,
stored in int8).  The kernels of mode ``fused`` exist for 8 bits only, so
with any other width that mode runs the int8 chain; its ``linear_q8`` then
declines too (the JAX package's hands the cross-K/V to its 8-bit kernel
whatever ``bits`` is).
"""

from __future__ import annotations

import warnings
from typing import Callable, Literal, Optional, get_args

import torch

from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K
from onnx_transformer_tpu_torch.parallel.collectives import model_sum
from onnx_transformer_tpu_torch.parallel.sharding import linear_kind, shard_payloads
from onnx_transformer_tpu_torch.quant import core as Q

Mode = Literal["int8", "fake", "pallas", "fused"]
MODES = get_args(Mode)

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


def quantize_model_params(model: Transformer, params: dict, bits: int = 8,
                          include_generator: bool = False) -> dict:
    """name -> {wq int8 [in, out], sw f32 [out], b f32 [out]}."""
    names = dict(quantized_linear_names(model.cfg.num_layers))
    if include_generator:
        names["generator.proj"] = False
    payloads = {}
    for name in names:
        leaf = _param_leaf(params, name)
        wq, sw = Q.quantize_weight_per_channel(leaf["w"].float(), bits)
        payloads[name] = {"wq": wq.contiguous(), "sw": sw, "b": leaf["b"].float()}
    return payloads


def _fused_ok(p: dict, name: str, x: torch.Tensor, bits: int, taps: L.TapDict = None,
              inject: L.InjectDict = None) -> bool:
    return (bits == 8 and taps is None and inject is None and is_quantized_output(name)
            and x[..., 0].numel() >= FUSED_MIN_TOKENS
            and x.shape[-1] <= K.MAX_KN and p["wq"].shape[-1] <= K.MAX_KN)


def make_w8a8_linear_impl(payloads: dict, mode: Mode = "int8", bits: int = 8,
                          mesh=None) -> Callable:
    """LinearImpl for ``Transformer`` methods: the W8A8 stand-in for every
    quantized linear, the plain fp linear for the rest.  With a ``mesh``,
    for the tensor-parallel view ``Transformer(cfg, mesh=mesh)`` over this
    rank's payload slices (``parallel.shard_payloads``); see the module
    docstring."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if mesh is not None and mode == "fused":
        warnings.warn("W8A8 mode 'fused' quantizes each output row whole inside K1/K2, and "
                      "under a tensor-parallel mesh a rank holds part of the row: running "
                      "mode 'pallas' (K5 on the column-parallel linears) instead", stacklevel=2)
        mode = "pallas"

    def lin(name: str, x, w, b, taps: L.TapDict = None, inject: L.InjectDict = None):
        p = payloads.get(name)
        row = mesh is not None and linear_kind(name) == "row"
        if p is None:
            if row:    # the plain row-parallel linear: partial products, then the bias
                return model_sum(default_linear(name, x, w, None, taps, inject), mesh) + b
            return default_linear(name, x, w, b, taps, inject)
        if mode == "fused" and _fused_ok(p, name, x, bits, taps, inject):
            return K.quant_w8a8_matmul_qout(x, p["wq"], p["sw"], p["b"])
        x = L.tap(name, x, taps, inject)
        # a row-parallel input holds this rank's columns of each row
        sx = Q.act_scale_per_token(x, bits, mesh if row else None)
        xq = L.tap(f"{name}.x_q", Q.quantize(x, sx, bits), taps, inject)
        wq = L.tap(f"{name}.w_q", p["wq"], taps, inject)
        if mode == "fake":
            y = torch.matmul(Q.dequantize(xq, sx), Q.dequantize(wq, p["sw"][None, :]))
            if row:
                y = model_sum(y, mesh)
            y = y + p["b"]
        elif row:
            # int8 and pallas: the exact int32 sum, then K5's plain epilogue
            acc = model_sum(K.int_mm(xq.reshape(-1, xq.shape[-1]), wq), mesh)
            y = K.w8a8_epilogue(acc, sx.reshape(-1), p["sw"], p["b"]).reshape(*x.shape[:-1],
                                                                              -1)
        elif mode == "pallas":
            y = K.w8a8_matmul(xq, sx[..., 0], wq, p["sw"], p["b"])
        else:   # "int8": K5's plain version on every device
            y = K.w8a8_matmul_ref(xq.reshape(-1, xq.shape[-1]), sx.reshape(-1), wq,
                                  p["sw"], p["b"]).reshape(*x.shape[:-1], -1)
        y = L.tap(f"{name}.out", y, taps, inject)
        if is_quantized_output(name):
            y = L.tap(f"{name}.out_q", Q.fake_quant_act_per_token(y, bits, mesh), taps, inject)
        return y

    if mode == "fused":
        def linear_q8(name, x, w=None, b=None):
            """(int8 rows, per-token scales) straight from kernel K2, or
            None when the call cannot take the kernel."""
            p = payloads.get(name)
            if p is None or not _fused_ok(p, name, x, bits):
                return None
            return K.quant_w8a8_matmul_q8(x, p["wq"], p["sw"], p["b"])

        lin.linear_q8 = linear_q8
    lin.payloads = payloads
    lin.mode = mode
    lin.bits = bits
    lin.mesh = mesh
    lin.shard = lambda m: make_w8a8_linear_impl(shard_payloads(payloads, m), mode, bits, m)
    # q/k/v outputs sit exactly on the per-token int8 grid, so a decode
    # attention may recover their int8 form losslessly
    lin.quantized_output_grid = True
    return lin


def shard_linear_impl(lin: Callable, mesh) -> Callable:
    """The tensor-parallel counterpart of a linear impl made for one device:
    the plain linear stays as it is; a W8A8, W4A8 or QAT impl is made again
    for ``mesh`` (over this rank's payload slices); an impl already made for
    ``mesh`` is returned as it is; any other impl is refused."""
    if lin is default_linear or getattr(lin, "mesh", None) is mesh:
        return lin
    if getattr(lin, "shard", None) is None or getattr(lin, "mesh", None) is not None:
        raise ValueError("a tensor-parallel mesh takes the plain linear or a one-device W8A8, "
                         "W4A8 or QAT impl (make_w8a8_linear_impl, make_w4a8_linear_impl, "
                         "make_qat_linear_impl)")
    return lin.shard(mesh)


def quantize_transformer(model: Transformer, params: dict,
                         act_scales: Optional[dict] = None, alpha: float = 0.5,
                         mode: Mode = "int8", bits: int = 8,
                         include_generator: bool = False):
    """SmoothQuant-migrate with calibrated scales, then quantize.  Returns
    (smoothed_params, linear_impl)."""
    from onnx_transformer_tpu_torch.quant.smoothquant import smooth_params

    if act_scales is not None:
        params = smooth_params(params, act_scales, alpha)
    payloads = quantize_model_params(model, params, bits, include_generator)
    return params, make_w8a8_linear_impl(payloads, mode, bits)
