#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``onnx_transformer_tpu_torch``).

    python3 chip_smoke.py        # needs one CUDA card; no arguments

Phases, each printed on its own line with its seconds:

1. device     the card's name and power limit; fails without a CUDA card.
2. build      nvcc builds the kernels of ``onnx_transformer_tpu_torch/csrc``
              into ``onnx_transformer_tpu_torch/_build/``.
3. kernels    K1 (quant_w8a8_matmul_qout) and K2 (quant_w8a8_matmul_q8) on
              the card against their plain PyTorch versions, bit for bit, at
              the main-path shape, a ragged M and the JAX tests' shape; CUDA
              event times of kernel, plain version and ``torch._int_mm`` alone
              (a partial yardstick: no single PyTorch call computes K1 or K2)
              beside the bound at the main-path shape.
4. main path  the IWSLT14-base widths (6+6 layers, d_model 512, d_ff 2048,
              8 heads, vocabularies 5337/4444) with weights from a seed,
              SmoothQuant with the scales artifact, W8A8 in "fused" mode, and
              the chunk-staged greedy decode of B=512 sources of length 72
              (max_len 72, chunk 8).  K1 must launch 18 times and K2 12 times
              in the decode; the same decode in "int8" mode must give the same
              encoder memory (atol 1e-4, rtol 1e-5) and >= 95 % of its tokens.
              One more decode runs under torch.profiler: the device's busy
              share of the wall time, the kernel launches, the top kernels.
5. reference  a small model decoded on the card and on the CPU from the same
              weights: >= 95 % of the tokens agree.

The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero without it.  A SIGALRM guard turns a hang into a non-zero
exit that names the phase.  Nothing is written but the kernel build.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

TOTAL_BUDGET_S = 300
PHASE_LIMIT_S = {"device": 60, "build": 120, "kernels": 120, "main path": 180,
                 "reference": 60}
# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
KERNEL_SOURCE = "onnx_transformer_tpu_torch/csrc/w8a8_matmul.cu"
PALLAS_FILE = "onnx_transformer_tpu/ops/pallas/w8a8_matmul.py"

_current_phase = "start"


class PhaseTimeout(RuntimeError):
    pass


def _on_alarm(signum, frame):
    raise PhaseTimeout(f"phase '{_current_phase}' was running when the "
                       f"{TOTAL_BUDGET_S} s budget ran out")


@contextmanager
def phase(name: str):
    global _current_phase
    _current_phase = name
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    print(f"phase {name}: {dt:.3f} s", flush=True)
    if dt > PHASE_LIMIT_S[name]:
        raise PhaseTimeout(f"phase '{name}' took {dt:.1f} s, over its {PHASE_LIMIT_S[name]} s limit")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time per call of ``fn``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_inputs(lead: tuple, k: int, n: int, seed: int, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((*lead, k), generator=g, device=device)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=device, dtype=torch.int8)
    sw = torch.rand(n, generator=g, device=device) * 0.009 + 0.001
    b = torch.randn(n, generator=g, device=device) * 0.1
    return x, wq, sw, b


def bound_ms(m: int, k: int, n: int, out_bytes_per_row: int) -> tuple[float, str]:
    """Least time for the card: x read once, W/sw/b read once, the output
    written once, against the int8 products at the tensor-core rate."""
    nbytes = m * k * 4 + k * n + 2 * n * 4 + m * out_bytes_per_row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(device, shapes, time_shape) -> dict:
    """Hold K1 and K2 against their plain versions at ``shapes``
    ((lead, K, N) tuples) and time them at ``time_shape``."""
    import torch

    from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K

    errs = {"qout": 0.0, "q8": 0.0}
    for i, (lead, k, n) in enumerate(shapes):
        x, wq, sw, b = kernel_inputs(lead, k, n, seed=100 + i, device=device)
        x2 = x.reshape(-1, k)
        before = (K.quant_w8a8_matmul_qout.launches, K.quant_w8a8_matmul_q8.launches)
        y = K.quant_w8a8_matmul_qout(x, wq, sw, b).reshape(-1, n)
        q, s = K.quant_w8a8_matmul_q8(x, wq, sw, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            if (K.quant_w8a8_matmul_qout.launches != before[0] + 1
                    or K.quant_w8a8_matmul_q8.launches != before[1] + 1):
                raise RuntimeError("a kernel wrapper did not count its launch")
        y_ref = K.quant_w8a8_matmul_qout_ref(x2, wq, sw, b)
        q_ref, s_ref = K.quant_w8a8_matmul_q8_ref(x2, wq, sw, b)
        q, s = q.reshape(-1, n), s.reshape(-1, 1)
        e1 = (y - y_ref).abs().max().item()
        e2 = max((q.int() - q_ref.int()).abs().max().item(), (s - s_ref).abs().max().item())
        ok = torch.equal(y, y_ref) and torch.equal(q, q_ref) and torch.equal(s, s_ref)
        print(f"kernels {tuple(x.shape)} x {tuple(wq.shape)}: qout max_abs_err {e1} "
              f"q8 max_abs_err {e2} bit-equal {ok}", flush=True)
        if not ok:
            raise AssertionError(f"kernel and plain version differ at {tuple(x.shape)}")
        errs["qout"] = max(errs["qout"], e1)
        errs["q8"] = max(errs["q8"], e2)

    lead, k, n = time_shape
    x, wq, sw, b = kernel_inputs(lead, k, n, seed=99, device=device)
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    xq = torch.round(x2 / (x2.abs().amax(-1, keepdim=True).clamp_min(1e-5) / 127)).to(torch.int8)
    t_int_mm = cuda_ms(lambda: K.int_mm(xq, wq))
    rows = {}
    for key, fn, ref, out_bytes in (
            ("qout", K.quant_w8a8_matmul_qout, K.quant_w8a8_matmul_qout_ref, 4 * n),
            ("q8", K.quant_w8a8_matmul_q8, K.quant_w8a8_matmul_q8_ref, n + 4)):
        t_plain_a = cuda_ms(lambda: ref(x2, wq, sw, b))
        t_kernel = cuda_ms(lambda: fn(x, wq, sw, b))
        t_plain_b = cuda_ms(lambda: ref(x2, wq, sw, b))
        bms, by = bound_ms(m, k, n, out_bytes)
        rows[key] = {"ms": t_kernel, "plain_ms": min(t_plain_a, t_plain_b),
                     "bound_ms": bms, "bound_by": by, "max_abs_err": errs[key],
                     "int_mm_partial_ms": t_int_mm}
        print(f"time {fn.__name__} at [{m},{k}]x[{k},{n}]: kernel {t_kernel:.6f} ms, "
              f"plain {t_plain_a:.6f}/{t_plain_b:.6f} ms, bound {bms:.6f} ms ({by}); "
              f"torch._int_mm alone (partial yardstick) {t_int_mm:.6f} ms", flush=True)
    return rows


def make_source(b: int, s: int, vocab: int, seed: int, device):
    """Random source ids with EOS at a random length per row and PAD after
    it; the first row is full length."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    src = torch.randint(4, vocab, (b, s), generator=g, dtype=torch.int32)
    lengths = torch.randint(max(2, s // 4), s + 1, (b,), generator=g)
    lengths[0] = s
    pos = torch.arange(s)[None, :]
    src = torch.where(pos == (lengths[:, None] - 1), torch.ones_like(src), src)
    src = torch.where(pos >= lengths[:, None], torch.full_like(src, 2), src)
    return src.to(device)


def profile_decode(decode, sync, wall_s: float) -> None:
    """One decode under torch.profiler, tracing the device only (host-side
    op recording would slow the host-bound loop tenfold): the device's busy
    time against ``wall_s``, the unprofiled wall time of the same decode,
    the kernel launches, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode()
        sync()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile one decode: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / (wall_s * 1e3):.1f} % of the {wall_s * 1e3:.3f} ms "
          f"unprofiled decode; {sum(e.count for e in kernels)} kernel launches",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}", flush=True)


def run_main_path(device, num_layers: int, batch: int, src_len: int, max_len: int,
                  chunk: int, card: str = "") -> dict:
    import torch

    import onnx_transformer_tpu_torch as P
    from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab
    from onnx_transformer_tpu_torch.ops import layers as L
    from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K

    vs, vt = load_iwslt14_vocab()
    cfg = P.TransformerConfig(len(vs), len(vt), num_layers=num_layers)
    model = P.Transformer(cfg)
    params = model.init(seed=0, device=device)
    sp, linf = P.quantize_transformer(model, params, P.load_reference_scales(), mode="fused")
    lin8 = P.make_w8a8_linear_impl(linf.payloads, mode="int8")
    stacked = P.build_stacked(model, sp, linf.payloads)
    src = make_source(batch, src_len, cfg.src_vocab_size, seed=1, device=device)
    sm = L.make_src_mask(src)

    def decode(lin):
        return P.greedy_decode_chunked(model, sp, stacked, src, sm, max_len,
                                       chunk=chunk, lin=lin)

    decode(linf)  # warm-up: cuBLAS handles, allocator
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    K.quant_w8a8_matmul_qout.launches = 0
    K.quant_w8a8_matmul_q8.launches = 0
    t0 = time.perf_counter()
    ys = decode(linf)
    sync()
    dt = time.perf_counter() - t0
    launches = {"qout": K.quant_w8a8_matmul_qout.launches,
                "q8": K.quant_w8a8_matmul_q8.launches}
    print(f"main path launches per decode: qout {launches['qout']} q8 {launches['q8']}",
          flush=True)
    if device.type == "cuda" and launches != {"qout": 3 * num_layers, "q8": 2 * num_layers}:
        raise AssertionError(f"expected {3 * num_layers} qout and {2 * num_layers} q8 "
                             f"launches, got {launches}")
    if tuple(ys.shape) != (batch, max_len) or not bool((ys[:, 0] == 0).all()):
        raise AssertionError(f"bad decode output shape {tuple(ys.shape)}")
    if int(ys.min()) < 0 or int(ys.max()) >= cfg.tgt_vocab_size:
        raise AssertionError("token id out of range")

    mem_f = model.encode(sp, src, sm, lin=linf)
    mem_8 = model.encode(sp, src, sm, lin=lin8)
    if not bool(torch.isfinite(mem_f).all()):
        raise AssertionError("encoder memory is not finite")
    torch.testing.assert_close(mem_f, mem_8, atol=1e-4, rtol=1e-5)
    ys8 = decode(lin8)
    agree = (ys == ys8).float().mean().item()
    print(f"main path fused vs int8: memory max_abs_diff "
          f"{(mem_f - mem_8).abs().max().item()} token agreement {agree}", flush=True)
    if agree < 0.95:
        raise AssertionError(f"token agreement {agree} < 0.95")
    tokens = batch * max_len
    print(f"main path B={batch} S={src_len} max_len={max_len} chunk={chunk}: "
          f"{dt:.6f} s per decode, {dt / max_len * 1e3:.6f} ms per step, "
          f"{tokens / dt:.3f} tokens/s on {card}", flush=True)
    if device.type == "cuda":
        profile_decode(lambda: decode(linf), sync, dt)
    return {"launches": launches, "seconds": dt, "agree": agree}


def run_reference(device) -> float:
    """The port's decode on ``device`` against the same decode on the CPU,
    small model, same weights."""
    import torch

    import onnx_transformer_tpu_torch as P
    from onnx_transformer_tpu_torch.ops import layers as L

    cfg = P.TransformerConfig(37, 31, num_layers=3, d_model=32, d_ff=64, num_heads=4)
    model = P.Transformer(cfg)
    params_cpu = model.init(seed=7, device="cpu")
    src_cpu = make_source(24, 9, 37, seed=5, device="cpu")
    out = {}
    for dev in (torch.device("cpu"), device):
        params = P.params_from_jax(params_cpu, device=dev)
        sp, lin = P.quantize_transformer(model, params, mode="fused")
        stacked = P.build_stacked(model, sp, lin.payloads)
        src = src_cpu.to(dev)
        out[dev.type] = P.greedy_decode_chunked(
            model, sp, stacked, src, L.make_src_mask(src), 12, chunk=4, lin=lin).cpu()
    agree = (out["cpu"] == out[device.type]).float().mean().item()
    print(f"reference small model {device.type} vs cpu token agreement {agree}", flush=True)
    if agree < 0.95:
        raise AssertionError(f"card and CPU decodes agree on {agree} < 0.95 of tokens")
    return agree


def main() -> int:
    faulthandler.dump_traceback_later(TOTAL_BUDGET_S + 60, exit=True)
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(TOTAL_BUDGET_S)

    import torch

    with phase("device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 1
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import onnx_transformer_tpu_torch  # noqa: F401  (fails outside the repo)

        device = torch.device("cuda")
        card = card_line()
        name = torch.cuda.get_device_name(0)
        print(f"card {card} | torch {torch.__version__} cuda {torch.version.cuda} | {name}",
              flush=True)

    with phase("build"):
        from onnx_transformer_tpu_torch.ops.kernels import build

        build.library()
        print(f"build {build.build_info}", flush=True)
        log = os.path.join(build.BUILD_DIR, "nvcc.log")
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        print("ptxas", line.strip().replace("ptxas info    : ", ""))

    with phase("kernels"):
        rows = check_kernels(device, [((512, 72), 512, 512), ((1000,), 512, 512),
                                      ((48,), 64, 96)], ((512, 72), 512, 512))

    with phase("main path"):
        main_res = run_main_path(device, num_layers=6, batch=512, src_len=72,
                                 max_len=72, chunk=8, card=card)

    with phase("reference"):
        run_reference(device)

    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    kernels = []
    for key, name_k, line in (("qout", "quant_w8a8_matmul_qout", 244),
                              ("q8", "quant_w8a8_matmul_q8", 188)):
        kernels.append({"name": name_k, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": f"{PALLAS_FILE}:{line}",
                        "launches": main_res["launches"][key], **rows[key],
                        "library_ms": None})
    print(f"card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
