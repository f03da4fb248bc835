"""Roofline of the W8A8 matmul kernels on the card (counterpart of
``scripts/kernel_roofline.py``), and the timer and bound formulas that the
card check (``chip_smoke.py``) uses for every kernel.

The rows time K5 (``w8a8_matmul``, "prequant": int8 activations with their
per-token scales) and K4 (``quant_w8a8_matmul``, "fused quant": the f32
activations quantized per token inside the kernel) through their wrappers,
at the model's serving shapes (the attention projections, the FFN and the
generator at d_model 512, 512 x 72 tokens) and at two square shapes, and
give the achieved TOP/s as a share of the card's dense int8 peak and the
least time the card could take (:func:`bound_ms`).  ``--sweep`` times every
tile of K5 and every configuration of K4 at the three large shapes, each
held bit for bit to the wrapper's output first.  It needs a CUDA card: the
plain versions are never timed in the kernels' place.

  python -m onnx_transformer_tpu_torch.ops.kernels.roofline [--json] [--sweep]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from onnx_transformer_tpu_torch.device import resolve_device

# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
SM_CLOCK_HZ = 1.98e9   # H100 SXM boost clock: sleep cycles -> seconds

# Dense int8 peaks (TOP/s, without sparsity) by the name the card reports
# (``torch.cuda.get_device_name``), NVIDIA's data sheet; a share of the
# wrong card's peak means nothing, so an unknown name needs --peak-tops.
PEAK_INT8_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 1979e12,   # SXM
    "NVIDIA H100 SXM": 1979e12,
    "NVIDIA H100 PCIe": 1513e12,
}

B, T = 512, 72  # serving batch x max_len
SHAPES = [
    (B * T, 512, 512, "attn q/k/v/o proj"),
    (B * T, 512, 2048, "ffn w1"),
    (B * T, 2048, 512, "ffn w2"),
    (B * T, 512, 4480, "generator (vocab 4444 padded)"),
    (8192, 2048, 2048, "square 8k*2k*2k"),
    (16384, 4096, 4096, "square 16k*4k*4k (saturating)"),
]
SWEEP_SHAPES = [(16384, 4096, 4096), (36864, 512, 4480), (36864, 2048, 512)]


def peak_for(device_kind: str, override: float | None = None) -> float:
    if override:
        return override
    for k, v in PEAK_INT8_BY_KIND.items():
        if device_kind.startswith(k):
            return v
    raise SystemExit(
        f"unknown device kind {device_kind!r}: pass --peak-tops explicitly")


def cuda_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time per call of ``fn``.

    Each rep's ``iters`` calls are enqueued behind a device-side sleep that
    lasts about four times as long as the host takes to enqueue them, so the
    events time the device running the calls back to back; a kernel of a
    few tens of microseconds would otherwise be timed at the host's launch
    rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(4 * host_s * SM_CLOCK_HZ) + 1000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def roofline_ms(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations over
    their peak rate, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(m: int, k: int, n: int, out_bytes_per_row: int,
             w_bytes: int | None = None) -> tuple[float, str]:
    """Least time for a fused quantize-matmul (K1/K2/K4/K6/K7/K8): x f32
    read once, the weights (``w_bytes``: k*n for int8, k*n/2 packed int4)
    and sw/b read once, the output written once, against the int8 products
    at the tensor-core rate."""
    w_bytes = k * n if w_bytes is None else w_bytes
    nbytes = m * k * 4 + w_bytes + 2 * n * 4 + m * out_bytes_per_row
    return roofline_ms(nbytes, 2 * m * n * k, INT8_OPS_PER_S)


def w8a8_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for K5: xq int8 and sx f32 read once, the int8 weights and
    sw/b read once, the f32 output written once, against the int8 products
    at the tensor-core rate."""
    return roofline_ms(m * k + m * 4 + k * n + 2 * n * 4 + m * n * 4, 2 * m * n * k,
                       INT8_OPS_PER_S)


def flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def roofline_row(m: int, k: int, n: int, tag: str, pre_ms: float, fused_ms: float,
                 peak: float) -> dict:
    """One row: each kernel's TOP/s and share of ``peak`` from its time, and
    its bound."""
    f = flops(m, k, n)
    return {"shape": f"{m}x{k}x{n}", "tag": tag,
            "prequant_tops": f / (pre_ms * 1e-3) / 1e12,
            "prequant_roofline": f / (pre_ms * 1e-3) / peak,
            "fused_quant_tops": f / (fused_ms * 1e-3) / 1e12,
            "fused_quant_roofline": f / (fused_ms * 1e-3) / peak,
            "prequant_ms": pre_ms, "fused_quant_ms": fused_ms,
            "prequant_bound_ms": w8a8_bound_ms(m, k, n)[0],
            "fused_quant_bound_ms": bound_ms(m, k, n, 4 * n)[0]}


def _inputs(m: int, k: int, n: int, device, seed: int = 0):
    """x f32, its int8 rows xq with per-token scales sx, int8 weights wq
    [k, n] and sw f32 [n], drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    sx = torch.full((m,), 0.02, device=device)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=device, dtype=torch.int8)
    sw = torch.full((n,), 0.01, device=device)
    return x, xq, sx, wq, sw


def run(shapes, peak: float, device=None) -> list[dict]:
    """K5 and K4 timed through their wrappers at ``shapes`` ((M, K, N, tag))."""
    from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K

    device = device or resolve_device()
    rows = []
    for m, k, n, tag in shapes:
        x, xq, sx, wq, sw = _inputs(m, k, n, device)
        b = torch.zeros(n, device=device)
        t_pre = cuda_ms(lambda: K.w8a8_matmul(xq, sx, wq, sw, b))
        t_fused = cuda_ms(lambda: K.quant_w8a8_matmul(x, wq, sw, b))
        rows.append(roofline_row(m, k, n, tag, t_pre, t_fused, peak))
        del x, xq, sx, wq, sw, b
    return rows


def sweep(peak: float, device=None, shapes=SWEEP_SHAPES) -> list[dict]:
    """Every tile of K5 and every configuration of K4 that holds K, at
    ``shapes``, launched directly (not counted), each bit-equal to its
    wrapper's output before it is timed."""
    from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K

    device = device or resolve_device()
    out_rows = []
    for m, k, n in shapes:
        x, xq, sx, wq, sw = _inputs(m, k, n, device)
        b = torch.zeros(n, device=device)
        f = flops(m, k, n)
        print(f"--- {m}x{k}x{n}")
        out = torch.empty((m, n), dtype=torch.float32, device=device)
        want = K.w8a8_matmul(xq, sx, wq, sw)
        for t, (bm, bn) in enumerate(K.W8A8_TILES):
            K.w8a8_gemm_launch(xq, sx, wq, sw, b, out, t)
            torch.cuda.synchronize(device)
            if not torch.equal(out, want):
                raise AssertionError(f"K5 tile {bm}x{bn} differs at {(m, k, n)}")
            ms = cuda_ms(lambda: K.w8a8_gemm_launch(xq, sx, wq, sw, b, out, t))
            out_rows.append({"shape": [m, k, n], "kernel": "w8a8_matmul",
                             "config": f"{bm}x{bn}", "ms": ms})
            print(f"  K5 tile {bm}x{bn}: {f / ms / 1e9:7.1f} TOPS "
                  f"({f / ms / 1e9 / (peak / 1e12) * 100:5.1f}% roofline), bit-equal")
        want = K.quant_w8a8_matmul(x, wq, sw)
        for t, (bm, resident) in enumerate(K.QGEMM_TILES):
            label = f"BM {bm}, x {'resident' if resident else 'streamed'}"
            try:
                K.plan_quant_gemm(m, k, n, tile=t)
            except ValueError:
                print(f"  K4 configuration {t} ({label}): does not hold K={k}")
                continue
            K.quant_gemm_launch(x, wq, sw, b, out, False, t)
            torch.cuda.synchronize(device)
            if not torch.equal(out, want):
                raise AssertionError(f"K4 configuration {t} differs at {(m, k, n)}")
            ms = cuda_ms(lambda: K.quant_gemm_launch(x, wq, sw, b, out, False, t))
            out_rows.append({"shape": [m, k, n], "kernel": "quant_w8a8_matmul",
                             "config": label, "ms": ms})
            print(f"  K4 configuration {t} ({label}): {f / ms / 1e9:7.1f} TOPS "
                  f"({f / ms / 1e9 / (peak / 1e12) * 100:5.1f}% roofline), bit-equal")
        del x, xq, sx, wq, sw, out, want
    return out_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m onnx_transformer_tpu_torch.ops.kernels.roofline")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--peak-tops", type=float, default=None,
                    help="the card's dense int8 peak in TOP/s (required for unknown kinds)")
    args = ap.parse_args(argv)
    device = resolve_device()
    kind = torch.cuda.get_device_name(device)
    peak = peak_for(kind, args.peak_tops * 1e12 if args.peak_tops else None)
    if args.sweep:
        sweep(peak, device)
        return 0
    rows = run(SHAPES, peak, device)
    if args.json:
        print(json.dumps({"device": kind, "peak_int8_tops": peak / 1e12, "rows": rows}))
        return 0
    print(f"device: {kind}  peak int8: {peak / 1e12:.0f} TOPS")
    print(f"{'shape':>18} {'tag':<30} {'pre-q TOPS':>10} {'%roof':>6} {'bound ms':>9} "
          f"{'fused TOPS':>10} {'%roof':>6} {'bound ms':>9}")
    for r in rows:
        print(f"{r['shape']:>18} {r['tag']:<30} {r['prequant_tops']:>10.1f} "
              f"{r['prequant_roofline'] * 100:>5.1f}% {r['prequant_bound_ms']:>9.6f} "
              f"{r['fused_quant_tops']:>10.1f} "
              f"{r['fused_quant_roofline'] * 100:>5.1f}% {r['fused_quant_bound_ms']:>9.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
