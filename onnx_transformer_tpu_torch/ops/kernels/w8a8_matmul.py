"""K1 and K2: fused per-token quantize + int8 matmul + per-token output
quantization (port of ``quant_w8a8_matmul_qout`` and ``quant_w8a8_matmul_q8``
in ``onnx_transformer_tpu/ops/pallas/w8a8_matmul.py``).

Each wrapper launches the CUDA kernel of ``csrc/w8a8_matmul.cu`` for a CUDA
tensor and counts the launch in its ``launches`` attribute; for a CPU tensor
it takes the plain PyTorch version (``*_ref``) beside it, which the card
check also holds the kernel against, bit for bit.
"""

from __future__ import annotations

import torch

from onnx_transformer_tpu_torch.quant.core import act_scale_per_token, quantize

MAX_KN = 2048   # the TPU kernels' single-block limit on K and N


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact.  On the H100,
    cuBLASLt refuses some int8 products of two row-major operands with a
    dimension below 128 (48x64 @ 64x96 among them) and took every one tried
    with all dimensions at 128 or more; so on the card each dimension is
    zero-padded to at least 128, and K and N to multiples of 8.  Zeros add
    nothing to the sums."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a, b)
    pm = max(128 - m, 0)
    pk = max(128, k + -k % 8) - k
    pn = max(128, n + -n % 8) - n
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if (pm or pn) else out


def _w8a8_rows(x2: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
               b: torch.Tensor):
    """x2 f32 [M, K] -> (y f32 [M, N], sy f32 [M, 1]) before output rounding."""
    sx = act_scale_per_token(x2)
    acc = int_mm(quantize(x2, sx), wq)
    y = acc.float() * (sx * sw[None, :]) + b[None, :]
    return y, act_scale_per_token(y)


def quant_w8a8_matmul_qout_ref(x2, wq, sw, b) -> torch.Tensor:
    """Plain version of K1 on x2 [M, K]: f32 [M, N] on the output's
    per-token int8 grid."""
    y, sy = _w8a8_rows(x2, wq, sw, b)
    return torch.round(y / sy) * sy


def quant_w8a8_matmul_q8_ref(x2, wq, sw, b):
    """Plain version of K2 on x2 [M, K]: (int8 [M, N], f32 [M, 1])."""
    y, sy = _w8a8_rows(x2, wq, sw, b)
    return quantize(y, sy), sy


def _check(x, wq, sw, b):
    k = x.shape[-1]
    if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[0] != k:
        raise ValueError(f"wq must be int8 [K={k}, N], got {wq.dtype} {tuple(wq.shape)}")
    n = wq.shape[1]
    if k > MAX_KN or n > MAX_KN:
        raise ValueError(f"K={k} and N={n} must be <= {MAX_KN}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if b is None:
        b = torch.zeros(n, dtype=torch.float32, device=x.device)
    for name, t in (("sw", sw), ("b", b)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 [{n}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("wq", wq), ("sw", sw), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return x.reshape(-1, k), n, b


# C signatures of the entry points: "p" a pointer or the stream, "i" an int
_SIGNATURES = {"quant_w8a8_qout": "pppppiiip", "quant_w8a8_q8": "ppppppiiip"}


def _launch(fn: str, device: torch.device, *args):
    """Call a C entry point with the current stream of ``device`` appended;
    it returns the launch's cudaError_t."""
    import ctypes

    from onnx_transformer_tpu_torch.ops.kernels.build import library

    f = getattr(library(), fn)
    if f.argtypes is None:
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                      for c in _SIGNATURES[fn]]
    with torch.cuda.device(device):
        err = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {err}")


def _cuda_inputs(x2, wq, sw, b):
    for name, t in (("x", x2), ("wq", wq), ("sw", sw), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return x2.data_ptr(), wq.data_ptr(), sw.data_ptr(), b.data_ptr()


def quant_w8a8_matmul_qout(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                           b: torch.Tensor | None = None) -> torch.Tensor:
    """K1: x f32 [..., K] -> f32 [..., N] = per-token fake-quant of
    ``float(quantize(x) @ wq) * (sx * sw) + b``."""
    x2, n, b = _check(x, wq, sw, b)
    lead = x.shape[:-1]
    if not x.is_cuda:
        return quant_w8a8_matmul_qout_ref(x2, wq, sw, b).reshape(*lead, n)
    x2 = x2.contiguous()
    m, k = x2.shape
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m:
        _launch("quant_w8a8_qout", x.device, *_cuda_inputs(x2, wq, sw, b),
                out.data_ptr(), m, k, n)
        quant_w8a8_matmul_qout.launches += 1
    return out.reshape(*lead, n)


def quant_w8a8_matmul_q8(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                         b: torch.Tensor | None = None):
    """K2: x f32 [..., K] -> (int8 [..., N], f32 [..., 1]): the output rows
    quantized per token, and their scales."""
    x2, n, b = _check(x, wq, sw, b)
    lead = x.shape[:-1]
    if not x.is_cuda:
        q, s = quant_w8a8_matmul_q8_ref(x2, wq, sw, b)
        return q.reshape(*lead, n), s.reshape(*lead, 1)
    x2 = x2.contiguous()
    m, k = x2.shape
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        _launch("quant_w8a8_q8", x.device, *_cuda_inputs(x2, wq, sw, b),
                q.data_ptr(), s.data_ptr(), m, k, n)
        quant_w8a8_matmul_q8.launches += 1
    return q.reshape(*lead, n), s.reshape(*lead, 1)


quant_w8a8_matmul_qout.launches = 0
quant_w8a8_matmul_q8.launches = 0
