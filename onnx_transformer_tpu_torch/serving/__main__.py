"""Continuous-batching translation server CLI (counterpart of
``scripts/serve.py``).

Reads BPE-tokenised German source sentences (a file, or stdin), runs them
through the slot-based :class:`TranslationEngine` and prints one
translation per line, in input order; a summary goes to stderr.

Modes: fp32, int8 (W8A8 with the calibrated SmoothQuant scales, the int8
chain), pallas (the same with kernel K5), int4 (W4A8 packed nibbles, K6/K7
in the prefill); ``--kv-dtype int8`` keeps the KV cache in int8 and
``--fused-attn`` sends its attention to kernel K3.  A missing checkpoint
gives a warning and params from a seed.  It runs on the card unless
``--platform cpu`` is given.

``--tp N`` serves over a tensor-parallel mesh of N ranks (``make_mesh(model=N)``),
one process each (``parallel.launch``): each rank builds the engine, shards
the weights and its KV cache, and rank 0's translations are printed.  The
ranks meet over nccl, one card each, or over gloo on the CPU.  Every mode
shards: int4's packed payloads by whole row pairs, with K6/K7 stepping aside
(they quantize each output row whole) for K8 on the column-parallel linears
and the plain chain on the row-parallel ones.

  echo "das ist ein test" | python -m onnx_transformer_tpu_torch.serving --mode fp32
  python -m onnx_transformer_tpu_torch.serving --input src.bpe --mode pallas \\
      --kv-dtype int8 --fused-attn
  python -m onnx_transformer_tpu_torch.serving --input src.bpe --mode int8 \\
      --kv-dtype int8 --tp 2 --platform cpu
  python -m onnx_transformer_tpu_torch.serving --input src.bpe --mode int4 \\
      --kv-dtype int8 --tp 2 --platform cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab
from onnx_transformer_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                                           default_linear)


def model_config(vocab_src, vocab_tgt) -> TransformerConfig:
    """The IWSLT14-base configuration over the two vocabularies."""
    return TransformerConfig(len(vocab_src), len(vocab_tgt))


def translate(args, cfg: TransformerConfig, vs, vt, lines: list, tp: bool = False):
    """The engine's translations of ``lines`` in input order, the token
    count and the engine's seconds; with ``tp``, as one rank of a launched
    world, over ``make_mesh(model=args.tp)``."""
    import numpy as np

    from onnx_transformer_tpu_torch.data.dataset import encode_sentence, unbpe
    from onnx_transformer_tpu_torch.device import resolve_device
    from onnx_transformer_tpu_torch.params import load_checkpoint_params
    from onnx_transformer_tpu_torch.serving.engine import TranslationEngine

    device = resolve_device(args.platform)
    mesh = None
    if tp:
        import torch.distributed as dist

        from onnx_transformer_tpu_torch.parallel.mesh import make_mesh

        if device.type == "cuda":
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        mesh = make_mesh(model=args.tp, device=device)
    model = Transformer(cfg)
    if os.path.exists(args.ckpt):
        params = load_checkpoint_params(args.ckpt, device)
    else:
        if not tp or mesh.model_rank == 0:
            print(f"warning: {args.ckpt} missing, random params", file=sys.stderr)
        params = model.init(seed=0, device=device)

    lin = default_linear
    if args.mode in ("int8", "pallas"):
        from onnx_transformer_tpu_torch.quant.smoothquant import (SCALES_PATH,
                                                                  load_reference_scales)
        from onnx_transformer_tpu_torch.quant.w8a8 import quantize_transformer

        scales_path = args.scales if args.scales and os.path.exists(args.scales) else SCALES_PATH
        scales = load_reference_scales(scales_path) if os.path.exists(scales_path) else None
        params, lin = quantize_transformer(model, params, scales, mode=args.mode)
    elif args.mode == "int4":
        from onnx_transformer_tpu_torch.quant.int4 import (make_w4a8_linear_impl,
                                                           quantize_model_params_int4)

        lin = make_w4a8_linear_impl(quantize_model_params_int4(model, params))

    eng = TranslationEngine(
        model, params, lin=lin, num_slots=args.num_slots, src_len=args.src_len,
        max_len=args.max_len, kv_cache_dtype=args.kv_dtype, fused_attn=args.fused_attn,
        beam_size=args.beam, mesh=mesh)
    order = {}
    for n, line in enumerate(lines):
        ids = encode_sentence(line, vs, args.src_len)
        order[eng.submit(np.asarray(ids, np.int32))] = n

    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0

    out = [""] * len(lines)
    ntok = 0
    for req in done:
        toks = [vt.itos[t] for t in req.out_tokens]
        ntok += len(toks)
        out[order[req.req_id]] = " ".join(toks) if args.raw else unbpe(toks)
    return out, ntok, dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m onnx_transformer_tpu_torch.serving")
    ap.add_argument("--ckpt", default="checkpoints/iwslt14/model_final.npz")
    ap.add_argument("--mode", choices=["fp32", "int8", "pallas", "int4"], default="fp32")
    ap.add_argument("--scales", default="scales/transformer_scales.npz")
    ap.add_argument("--kv-dtype", choices=["fp32", "int8"], default="fp32")
    ap.add_argument("--fused-attn", action="store_true",
                    help="kernel K3 for the int8-cache attention (needs --kv-dtype int8)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel width: shard weights + KV cache over a model mesh "
                         "axis of this size, one process per rank")
    ap.add_argument("--input", default="-", help="source file of BPE lines, or - for stdin")
    ap.add_argument("--num-slots", type=int, default=32)
    ap.add_argument("--beam", type=int, default=1,
                    help="slot-group beam width K (K consecutive slots per request; GNMT "
                         "length-normalised best hypothesis)")
    ap.add_argument("--src-len", type=int, default=72)
    ap.add_argument("--max-len", type=int, default=72)
    ap.add_argument("--raw", action="store_true", help="print BPE tokens, no @@-unmerge")
    ap.add_argument("--platform", default=None,
                    help="torch device type (cpu or cuda); the card by default")
    args = ap.parse_args(argv)

    from onnx_transformer_tpu_torch.device import resolve_device

    device = resolve_device(args.platform)
    vs, vt = load_iwslt14_vocab()
    cfg = model_config(vs, vt)
    if args.input == "-":
        lines = sys.stdin.read().splitlines()
    else:
        with open(args.input) as f:
            lines = f.read().splitlines()

    if args.tp:
        from onnx_transformer_tpu_torch.parallel.launch import launch
        from onnx_transformer_tpu_torch.parallel.mesh import default_backend

        backend = default_backend(device)
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if backend == "nccl" and cards < args.tp:
            ap.error(f"--tp {args.tp} over nccl needs a card per rank and {cards} are here")
        # the spawned ranks unpickle translate by its module's name, which
        # this module lacks when it runs as __main__
        from onnx_transformer_tpu_torch.serving import __main__ as cli

        out, ntok, dt = launch(cli.translate, args.tp, args, cfg, vs, vt, lines, True,
                               backend=backend)
    else:
        out, ntok, dt = translate(args, cfg, vs, vt, lines)
    for line in out:
        print(line)
    print(f"# {len(lines)} sentences, {ntok} tokens in {dt:.2f}s "
          f"({ntok / max(dt, 1e-9):.0f} tok/s, mode={args.mode}, kv={args.kv_dtype}"
          f"{f', tp={args.tp}' if args.tp else ''})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
