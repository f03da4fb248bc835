"""The W8A8 and W4A8 matmul kernels (ports of ``onnx_transformer_tpu/ops/pallas/w8a8_matmul.py``).

- K1 ``quant_w8a8_matmul_qout`` and K2 ``quant_w8a8_matmul_q8``: fused
  per-token quantize + int8 matmul + per-token output quantization on the
  tensor cores (``csrc/w8a8_qrows.cu``), each CTA holding whole output
  rows, its configuration chosen from the shape by :func:`plan_w8a8_qrows`.
- K6 ``quant_w4a8_matmul_qout`` and K7 ``quant_w4a8_matmul_q8``: the same
  kernel body over packed-int4 weights (uint8 [K/2, N] nibble pairs,
  ``quant.core.pack_int4``), unpacked in shared memory as each W tile is
  transposed (``csrc/w4a8_qrows.cu``; the body is ``csrc/qrows.cuh``).
- K5 ``w8a8_matmul``: int8 matmul of pre-quantized activations with the
  ``acc * (sx * sw) + b`` epilogue on the tensor cores
  (``csrc/w8a8_gemm.cu``), its tile chosen from the shape by
  :func:`plan_w8a8_tile`.
- K4 ``quant_w8a8_matmul`` and K8 ``quant_w4a8_matmul``: the per-token
  quantize fused in front of K5's product and epilogue, over int8 or
  packed-int4 weights, at any K, on the tensor cores (``csrc/quant_gemm.cu``):
  each CTA quantizes a block of x rows once and sweeps N, its configuration
  and persistent grid chosen from the shape by :func:`plan_quant_gemm`.

Each kernel is a registered PyTorch operator, ``torch.ops.otk.<wrapper
name>``, so that a traced and exported program (``export.serialize``)
carries it: its CUDA implementation launches the kernel and counts the
launch in the wrapper's ``launches`` attribute, its CPU implementation is
the plain PyTorch version (``*_ref``) beside it, which the card check also
holds the kernel against, bit for bit, and its fake implementation gives
the outputs' shapes and dtypes to a trace.  The wrappers are the entry
points: they check their arguments (on fake tensors too), then call the
operator on the 2-D operands.  Weight operands (``wq``/``wp``, ``sw``,
``b``) must be contiguous and on the input's device; the input is made
contiguous.
"""

from __future__ import annotations

import functools

import torch

from onnx_transformer_tpu_torch.ops.kernels.build import launch
from onnx_transformer_tpu_torch.quant.core import act_scale_per_token, quantize, unpack_int4

OP_NAMESPACE = "otk"   # the kernels' operators: torch.ops.otk.<wrapper name>
MAX_KN = 2048      # K1/K2/K6/K7: the TPU kernels' single-block limit on K and N
MAX_K_W4A8 = 4096  # K8: the TPU kernel's limit on K

# K5's output tiles (BM, BN), by the index the kernel takes
# (``csrc/w8a8_gemm.cu``: 128x128 with 8 warps, the others with 4)
W8A8_TILES = ((128, 128), (64, 64), (64, 32), (32, 32))
# two CTAs for each of the H100's 132 SMs, near enough: the fastest of the
# four tiles at every serving shape timed on the card (PERF.md)
W8A8_MIN_CTAS = 256


def plan_w8a8_tile(m: int, n: int) -> tuple[int, int, int]:
    """K5's tile for an [m, K] x [K, n] product: the largest of
    ``W8A8_TILES`` whose grid has at least ``W8A8_MIN_CTAS`` CTAs, else the
    smallest.  Returns (tile index, CTAs along M, CTAs along N): the
    kernel's grid, blockIdx.x over M and blockIdx.y over N."""
    for i, (bm, bn) in enumerate(W8A8_TILES):
        grid = (-(-m // bm), -(-n // bn))
        if grid[0] * grid[1] >= W8A8_MIN_CTAS:
            return (i, *grid)
    return (i, *grid)


# K1/K2's and K6/K7's configurations (``csrc/qrows.cuh``), by the index the
# kernel takes: (BM, chunk columns, chunks, warps along M) of a 16-warp CTA
# that holds BM whole output rows of N <= chunks x chunk columns, 64 int32
# sums a thread at most
QROWS_TILES = ((64, 512, 1, 2), (32, 512, 1, 1), (32, 512, 2, 1), (16, 512, 4, 1))
QROWS_WARPS = 16
QROWS_STAGES = 3      # depth of the W tile ring
MAX_SMEM = 232448     # the H100's dynamic shared memory per block (opt-in)


def qrows_smem(tile: int, k: int, packed: bool = False) -> int:
    """Dynamic shared memory of K1/K2's configuration ``tile`` at depth k
    (with ``packed``, K6/K7's), as the kernel lays it out: a head (the row
    scales and the per-warp row maxima, to 128 bytes), then the larger of
    the loop's buffers (the resident int8 x rows [BM, K to 64, + 16], the
    ring of raw W tiles, [64, chunk + 16] int8 or [32, chunk + 16] packed,
    and the K-major [chunk, 80] W tile) and the f32 output staging [BM, N
    capacity + 8]."""
    bm, bn, ch, warps_m = QROWS_TILES[tile]
    head = -(-(bm * 4 + bm * (QROWS_WARPS // warps_m) * 4) // 128) * 128
    raw_rows = 32 if packed else 64
    loop = bm * (-(-k // 64) * 64 + 16) + QROWS_STAGES * raw_rows * (bn + 16) + bn * 80
    return head + max(loop, bm * (ch * bn + 8) * 4)


def plan_w8a8_qrows(m: int, k: int, n: int, packed: bool = False) -> tuple[int, int, int]:
    """K1/K2's configuration for an [m, k] x [k, n] product (with
    ``packed``, K6/K7's over packed-int4 weights, K even): the first of
    ``QROWS_TILES`` that holds n columns in at most ``MAX_SMEM`` bytes.
    Returns (tile index, shared-memory bytes, CTAs), the CTAs over M."""
    if not (0 < k <= MAX_KN and 0 < n <= MAX_KN):
        raise ValueError(f"K={k} and N={n} must be within 1..{MAX_KN}")
    if packed and k % 2:
        raise ValueError(f"K={k} must be even for packed-int4 weights")
    for i, (bm, bn, ch, _) in enumerate(QROWS_TILES):
        smem = qrows_smem(i, k, packed)
        if n <= bn * ch and smem <= MAX_SMEM:
            return i, smem, -(-m // bm)
    raise AssertionError(f"no configuration holds K={k}, N={n}")


# K4/K8's configurations (``csrc/quant_gemm.cu``), by the index the kernel
# takes: (BM, x resident) of an 8-warp CTA that walks output units of BM
# rows x QGEMM_BN columns; the kernels' registers allow two CTAs per SM
QGEMM_TILES = ((128, True), (64, True), (32, True), (64, False))
QGEMM_BLOCKS_PER_SM = 2
QGEMM_BN = 128
QGEMM_STAGES = 3      # depth of the W tile ring
MAX_RESIDENT_K = 2048  # a resident x row is held in registers while it is quantized
SM_SMEM = 233472      # the H100's shared memory per SM; each CTA also reserves 1 KB
H100_SMS = 132


def quant_gemm_smem(tile: int, k: int, packed: bool = False) -> int:
    """Dynamic shared memory of K4's configuration ``tile`` at depth k (with
    ``packed``, K8's), as the kernel lays it out: the row scales (to 128
    bytes), the int8 x tile (resident: [BM, K to 64, + 16]; streamed: one
    K tile [BM, 80]) and the ring of raw W tiles ([64, 128] int8 or [32,
    128] packed)."""
    bm, resident = QGEMM_TILES[tile]
    head = -(-bm * 4 // 128) * 128
    x_row = -(-k // 64) * 64 + 16 if resident else 80
    return head + bm * x_row + QGEMM_STAGES * (32 if packed else 64) * QGEMM_BN


def quant_gemm_units(m: int, n: int, tile: int) -> int:
    """Output units (BM rows x QGEMM_BN columns) of an [m, n] output."""
    return -(-m // QGEMM_TILES[tile][0]) * -(-n // QGEMM_BN)


def plan_quant_gemm(m: int, k: int, n: int, packed: bool = False, sms: int = H100_SMS,
                    tile: int | None = None) -> tuple[int, int, int]:
    """K4's configuration for an [m, k] x [k, n] product (with ``packed``,
    K8's over packed-int4 weights, K even), or ``tile`` where given: with x
    resident (K <= ``MAX_RESIDENT_K``) the largest BM whose shared memory
    holds K and whose units give each of the two CTAs on each of the card's
    ``sms`` SMs work, else BM 32; above that, BM 64 with x streamed by K
    tile.  Returns (tile index, shared-memory bytes, CTAs): a persistent
    grid of as many CTAs as the SMs hold at once, never more than the
    units, each walking a contiguous run of them."""
    if k <= 0 or n <= 0 or m < 0:
        raise ValueError(f"M={m}, K={k} and N={n} must be positive")
    if packed and k % 2:
        raise ValueError(f"K={k} must be even for packed-int4 weights")
    if tile is None:
        if k > MAX_RESIDENT_K:
            tile = 3
        else:
            tile = next((t for t in (0, 1) if quant_gemm_smem(t, k, packed) <= MAX_SMEM
                         and quant_gemm_units(m, n, t) >= QGEMM_BLOCKS_PER_SM * sms), 2)
    smem = quant_gemm_smem(tile, k, packed)
    if smem > MAX_SMEM or (QGEMM_TILES[tile][1] and k > MAX_RESIDENT_K):
        raise ValueError(f"configuration {tile} does not hold K={k}")
    per_sm = min(QGEMM_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))
    return tile, smem, max(1, min(quant_gemm_units(m, n, tile), sms * per_sm))


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


def w8a8_epilogue(acc: torch.Tensor, sx1: torch.Tensor, sw: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """K5's epilogue on the int32 product acc [M, N]: float(acc) * (sx1 *
    sw) + b (a tensor-parallel rank applies it to the product summed over
    its group)."""
    return acc.float() * (sx1[:, None] * sw[None, :]) + b[None, :]


def w8a8_matmul_ref(xq2: torch.Tensor, sx1: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 on xq2 int8 [M, K] with scales sx1 f32 [M]:
    f32 [M, N] = float(xq2 @ wq) * (sx1 * sw) + b, the ops of the "int8"
    chain of ``quant/w8a8.py`` one for one."""
    return w8a8_epilogue(int_mm(xq2, wq), sx1, sw, b)


def quant_w4a8_matmul_qout_ref(x2, wp, sw, b) -> torch.Tensor:
    """Plain version of K6: K1's on the unpacked int4 weights."""
    return quant_w8a8_matmul_qout_ref(x2, unpack_int4(wp), sw, b)


def quant_w4a8_matmul_q8_ref(x2, wp, sw, b):
    """Plain version of K7: K2's on the unpacked int4 weights."""
    return quant_w8a8_matmul_q8_ref(x2, unpack_int4(wp), sw, b)


def quant_w8a8_matmul_ref(x2, wq, sw, b) -> torch.Tensor:
    """Plain version of K4 on x2 f32 [M, K]: the per-token quantize, then
    K5's plain version."""
    sx = act_scale_per_token(x2)
    return w8a8_matmul_ref(quantize(x2, sx), sx[:, 0], wq, sw, b)


def quant_w4a8_matmul_ref(x2, wp, sw, b) -> torch.Tensor:
    """Plain version of K8: K4's on the unpacked int4 weights."""
    return quant_w8a8_matmul_ref(x2, unpack_int4(wp), sw, b)


def _check_w(k: int, wq, sw, b, device, packed: bool = False):
    """Validate the weight operands for an input of depth ``k``: int8
    [K, N], or with ``packed`` uint8 nibble pairs [K/2, N]; a missing bias
    becomes zeros.  Returns (N, b)."""
    if packed and k % 2:
        raise ValueError(f"K={k} must be even for packed-int4 weights")
    dtype, rows = (torch.uint8, k // 2) if packed else (torch.int8, k)
    if wq.dtype != dtype or wq.ndim != 2 or wq.shape[0] != rows:
        raise ValueError(f"the weights must be {dtype} [{rows}, N] for K={k}, "
                         f"got {wq.dtype} {tuple(wq.shape)}")
    n = wq.shape[1]
    if b is None:
        b = torch.zeros(n, dtype=torch.float32, device=device)
    for name, t in (("sw", sw), ("b", b)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 [{n}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("wq", wq), ("sw", sw), ("b", b)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the input on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, b


def _check(x, wq, sw, b, packed: bool, max_k: int | None = MAX_KN,
           max_n: int | None = MAX_KN):
    """Validate a fused quantize-matmul call; returns (x [M, K], N, b)."""
    k = x.shape[-1]
    n, b = _check_w(k, wq, sw, b, x.device, packed)
    if (max_k is not None and k > max_k) or (max_n is not None and n > max_n):
        raise ValueError(f"K={k} and N={n} must be within K <= {max_k}, N <= {max_n}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    return x.reshape(-1, k), n, b


def _ptrs(**tensors) -> list[int]:
    """Device pointers of contiguous operands, in the order given."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return [t.data_ptr() for t in tensors.values()]


def _count(name: str) -> None:
    """One more launch on the count of the wrapper ``name`` of this module
    (its ``launches`` attribute), from inside an operator's CUDA
    implementation: an eager call and a loaded exported program count
    alike."""
    globals()[name].launches += 1


def _qout_cuda(wrapper: str, entry: str, packed: bool):
    """The CUDA implementation of K1's (K6's) operator: x [M, K] -> f32 [M, N]."""
    def impl(x, wq, sw, b):
        x = x.contiguous()
        m, k = x.shape
        n = wq.shape[1]
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m:
            launch(entry, x.device, *_ptrs(x=x, wq=wq, sw=sw, b=b), out.data_ptr(), m, k, n,
                   *plan_w8a8_qrows(m, k, n, packed)[:2])
            _count(wrapper)
        return out
    return impl


def _q8_cuda(wrapper: str, entry: str, packed: bool):
    """The CUDA implementation of K2's (K7's) operator: x [M, K] -> (int8
    [M, N], f32 [M, 1])."""
    def impl(x, wq, sw, b):
        x = x.contiguous()
        m, k = x.shape
        n = wq.shape[1]
        q = torch.empty((m, n), dtype=torch.int8, device=x.device)
        s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
        if m:
            launch(entry, x.device, *_ptrs(x=x, wq=wq, sw=sw, b=b), q.data_ptr(),
                   s.data_ptr(), m, k, n, *plan_w8a8_qrows(m, k, n, packed)[:2])
            _count(wrapper)
        return q, s
    return impl


def _quant_gemm_cuda(wrapper: str, packed: bool):
    """The CUDA implementation of K4's (K8's) operator: x [M, K] -> f32 [M, N]."""
    def impl(x, wq, sw, b):
        x = x.contiguous()
        out = torch.empty((x.shape[0], wq.shape[1]), dtype=torch.float32, device=x.device)
        if out.numel():
            quant_gemm_launch(x, wq, sw, b, out, packed)
            _count(wrapper)
        return out
    return impl


def _w8a8_cuda(xq, sx, wq, sw, b):
    """The CUDA implementation of K5's operator: xq int8 [M, K], sx f32 [M]
    -> f32 [M, N]."""
    xq, sx = xq.contiguous(), sx.contiguous()
    m = xq.shape[0]
    out = torch.empty((m, wq.shape[1]), dtype=torch.float32, device=xq.device)
    if m:
        w8a8_gemm_launch(xq, sx, wq, sw, b, out, plan_w8a8_tile(m, wq.shape[1])[0])
        _count("w8a8_matmul")
    return out


def _rows_fake(x, wq, sw, b):
    return x.new_empty((x.shape[0], wq.shape[1]), dtype=torch.float32)


def _q8_fake(x, wq, sw, b):
    return (x.new_empty((x.shape[0], wq.shape[1]), dtype=torch.int8),
            x.new_empty((x.shape[0], 1), dtype=torch.float32))


def _w8a8_fake(xq, sx, wq, sw, b):
    return xq.new_empty((xq.shape[0], wq.shape[1]), dtype=torch.float32)


def _register(name: str, plain, cuda, fake, schema: str):
    """``otk::name``: the plain version on the CPU, ``cuda`` on the card,
    ``fake`` for tracing (the outputs' shapes and dtypes)."""
    op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", plain, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


_ROWS = "(Tensor x, Tensor wq, Tensor sw, Tensor b) -> Tensor"
_OPS = {
    "quant_w8a8_matmul_qout": _register(
        "quant_w8a8_matmul_qout", quant_w8a8_matmul_qout_ref,
        _qout_cuda("quant_w8a8_matmul_qout", "quant_w8a8_qout", False), _rows_fake, _ROWS),
    "quant_w8a8_matmul_q8": _register(
        "quant_w8a8_matmul_q8", quant_w8a8_matmul_q8_ref,
        _q8_cuda("quant_w8a8_matmul_q8", "quant_w8a8_q8", False), _q8_fake,
        "(Tensor x, Tensor wq, Tensor sw, Tensor b) -> (Tensor, Tensor)"),
    "quant_w4a8_matmul_qout": _register(
        "quant_w4a8_matmul_qout", quant_w4a8_matmul_qout_ref,
        _qout_cuda("quant_w4a8_matmul_qout", "quant_w4a8_qout", True), _rows_fake, _ROWS),
    "quant_w4a8_matmul_q8": _register(
        "quant_w4a8_matmul_q8", quant_w4a8_matmul_q8_ref,
        _q8_cuda("quant_w4a8_matmul_q8", "quant_w4a8_q8", True), _q8_fake,
        "(Tensor x, Tensor wq, Tensor sw, Tensor b) -> (Tensor, Tensor)"),
    "quant_w8a8_matmul": _register(
        "quant_w8a8_matmul", quant_w8a8_matmul_ref,
        _quant_gemm_cuda("quant_w8a8_matmul", False), _rows_fake, _ROWS),
    "quant_w4a8_matmul": _register(
        "quant_w4a8_matmul", quant_w4a8_matmul_ref,
        _quant_gemm_cuda("quant_w4a8_matmul", True), _rows_fake, _ROWS),
    "w8a8_matmul": _register(
        "w8a8_matmul", w8a8_matmul_ref, _w8a8_cuda, _w8a8_fake,
        "(Tensor xq, Tensor sx, Tensor wq, Tensor sw, Tensor b) -> Tensor"),
}


def _qout(name: str, x, wq, sw, b, packed: bool):
    x2, n, b = _check(x, wq, sw, b, packed)
    return _OPS[name](x2, wq, sw, b).reshape(*x.shape[:-1], n)


def _q8(name: str, x, wq, sw, b, packed: bool):
    x2, n, b = _check(x, wq, sw, b, packed)
    lead = x.shape[:-1]
    q, s = _OPS[name](x2, wq, sw, b)
    return q.reshape(*lead, n), s.reshape(*lead, 1)


def _quant_gemm(name: str, x, wq, sw, b, packed: bool, max_k: int | None):
    x2, n, b = _check(x, wq, sw, b, packed, max_k=max_k, max_n=None)
    return _OPS[name](x2, wq, sw, b).reshape(*x.shape[:-1], n)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quant_gemm_launch(x2, wq, sw, b, out, packed: bool, tile: int | None = None) -> None:
    """Launch K4's kernel (with ``packed``, K8's) on checked CUDA operands
    (x2 [M, K], out [M, N]) with the planner's configuration for this
    card, or with ``tile``; counts nothing.  The wrappers call it with the
    planner's pick; the card check also times the other configurations
    through it."""
    m, k = x2.shape
    n = out.shape[1]
    plan = plan_quant_gemm(m, k, n, packed, _sm_count(x2.device.index), tile)
    launch("quant_w4a8_gemm" if packed else "quant_w8a8_gemm", x2.device,
           *_ptrs(x=x2, wq=wq, sw=sw, b=b, out=out), m, k, n, *plan)


def quant_w8a8_matmul_qout(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                           b: torch.Tensor | None = None) -> torch.Tensor:
    """K1: x f32 [..., K] -> f32 [..., N] = per-token fake-quant of
    ``float(quantize(x) @ wq) * (sx * sw) + b``; K, N <= 2048."""
    return _qout("quant_w8a8_matmul_qout", x, wq, sw, b, packed=False)


def quant_w8a8_matmul_q8(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                         b: torch.Tensor | None = None):
    """K2: x f32 [..., K] -> (int8 [..., N], f32 [..., 1]): the output rows
    quantized per token, and their scales; K, N <= 2048."""
    return _q8("quant_w8a8_matmul_q8", x, wq, sw, b, packed=False)


def quant_w4a8_matmul_qout(x: torch.Tensor, wp: torch.Tensor, sw: torch.Tensor,
                           b: torch.Tensor | None = None) -> torch.Tensor:
    """K6: K1 over packed-int4 weights wp uint8 [K/2, N]; K, N <= 2048."""
    return _qout("quant_w4a8_matmul_qout", x, wp, sw, b, packed=True)


def quant_w4a8_matmul_q8(x: torch.Tensor, wp: torch.Tensor, sw: torch.Tensor,
                         b: torch.Tensor | None = None):
    """K7: K2 over packed-int4 weights wp uint8 [K/2, N]; K, N <= 2048."""
    return _q8("quant_w4a8_matmul_q8", x, wp, sw, b, packed=True)


def quant_w8a8_matmul(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """K4: x f32 [..., K] -> f32 [..., N] = ``float(quantize(x) @ wq) *
    (sx * sw) + b`` with the per-token scale of the whole row; any K, N."""
    return _quant_gemm("quant_w8a8_matmul", x, wq, sw, b, packed=False, max_k=None)


def quant_w4a8_matmul(x: torch.Tensor, wp: torch.Tensor, sw: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """K8: K4 over packed-int4 weights wp uint8 [K/2, N]; K even and
    <= 4096, any N."""
    return _quant_gemm("quant_w4a8_matmul", x, wp, sw, b, packed=True, max_k=MAX_K_W4A8)


def w8a8_matmul(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                sw: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """K5: xq int8 [..., K] with per-token scales sx f32 [...] ->
    f32 [..., N] = float(xq @ wq) * (sx * sw) + b; any M, K and N."""
    k = xq.shape[-1]
    n, b = _check_w(k, wq, sw, b, xq.device)
    lead = xq.shape[:-1]
    if xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8, got {xq.dtype}")
    if sx.dtype != torch.float32 or tuple(sx.shape) != tuple(lead):
        raise ValueError(f"sx must be float32 {tuple(lead)}, got {sx.dtype} {tuple(sx.shape)}")
    if sx.device != xq.device:
        raise ValueError(f"sx is on {sx.device}, xq on {xq.device}")
    return _OPS["w8a8_matmul"](xq.reshape(-1, k), sx.reshape(-1), wq, sw, b).reshape(*lead, n)


def w8a8_gemm_launch(xq2, sx1, wq, sw, b, out, tile: int) -> None:
    """Launch K5's kernel with the tile ``tile`` of ``W8A8_TILES`` on
    checked CUDA operands (xq2 [M, K], sx1 [M], out [M, N]); counts
    nothing.  The wrapper calls it with the planner's tile; the card check
    also times the other tiles through it."""
    m, k = xq2.shape
    launch("w8a8_gemm", xq2.device, *_ptrs(xq=xq2, sx=sx1, wq=wq, sw=sw, b=b, out=out),
           m, k, wq.shape[1], tile)


for _fn in (quant_w8a8_matmul_qout, quant_w8a8_matmul_q8, quant_w4a8_matmul_qout,
            quant_w4a8_matmul_q8, quant_w8a8_matmul, quant_w4a8_matmul, w8a8_matmul):
    _fn.launches = 0
