"""Export CLI: serve-format ``torch.export`` bundles of the IWSLT14 model
(counterpart of ``scripts/export.py``).

One command exports the encoder, the full greedy decode, the prefill and
the KV-cached decode step per batch bucket (``export.serialize``), fp32 or
W8A8 (the int8 chain) with the quantized weights as the programs'
constants, plus the params and a manifest; ``--onnx`` also writes the QDQ
ONNX graphs.  It runs on the card unless ``--cpu`` is given.  (Programs
that call the Hopper kernels come from ``export_model`` with a W8A8 impl in
mode ``pallas`` or ``fused``, or ``fused_attn``.)

  python -m onnx_transformer_tpu_torch.export --mode int8 --out exports/iwslt14_int8 \\
      --batch-sizes 1,8
"""

from __future__ import annotations

import argparse
import os
import sys

from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab
from onnx_transformer_tpu_torch.device import resolve_device
from onnx_transformer_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                                           default_linear)
from onnx_transformer_tpu_torch.quant.smoothquant import SCALES_PATH


def model_config(vocab_src, vocab_tgt) -> TransformerConfig:
    """The IWSLT14-base configuration over the two vocabularies."""
    return TransformerConfig(len(vocab_src), len(vocab_tgt))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m onnx_transformer_tpu_torch.export")
    ap.add_argument("--ckpt", default="checkpoints/iwslt14/model_final.npz")
    ap.add_argument("--scales", default=SCALES_PATH)
    ap.add_argument("--mode", choices=["fp32", "int8"], default="int8")
    ap.add_argument("--kv-cache", choices=["fp32", "int8"], default=None,
                    help="defaults to --mode")
    ap.add_argument("--batch-sizes", default="1,8")
    ap.add_argument("--src-len", type=int, default=72)
    ap.add_argument("--max-len", type=int, default=72)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--onnx", action="store_true",
                    help="also emit QDQ encoder.onnx/decoder.onnx (weight-QDQ graphs any "
                         "ONNX runtime loads)")
    ap.add_argument("--onnx-qcdq", action="store_true",
                    help="with --onnx: bake static activation QCDQ pairs from the "
                         "calibrated scales")
    args = ap.parse_args(argv)

    from onnx_transformer_tpu_torch.export.serialize import export_model
    from onnx_transformer_tpu_torch.params import load_checkpoint_params
    from onnx_transformer_tpu_torch.quant import w8a8 as W
    from onnx_transformer_tpu_torch.quant.smoothquant import load_reference_scales

    device = resolve_device("cpu" if args.cpu else None)
    vs, vt = load_iwslt14_vocab()
    model = Transformer(model_config(vs, vt))
    params = load_checkpoint_params(args.ckpt, device)

    lin = default_linear
    kv = args.kv_cache or args.mode
    scales = (load_reference_scales(args.scales)
              if args.scales and os.path.exists(args.scales) else None)
    if args.mode == "int8":
        params, lin = W.quantize_transformer(model, params, scales, mode="int8")

    out = args.out or f"exports/iwslt14_{args.mode}"
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    bundle = export_model(model, params, out, batch_sizes=batch_sizes, src_len=args.src_len,
                          max_len=args.max_len, lin=lin, mode=args.mode, kv_cache_dtype=kv)
    for name, seconds in bundle.seconds.items():
        size = os.path.getsize(os.path.join(out, name))
        print(f"  {name}: exported in {seconds:.3f} s, {size / 1e6:.1f} MB")
    if args.onnx:
        from onnx_transformer_tpu_torch.export.onnx_qdq import export_qdq_onnx

        payloads = W.quantize_model_params(model, params)
        paths = export_qdq_onnx(model, params, payloads, out,
                                act_scales=scales if args.onnx_qcdq else None)
        for k, pth in paths.items():
            print(f"  {k}.onnx: {os.path.getsize(pth) / 1e6:.1f} MB")
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"exported {args.mode} bundle -> {out} ({total / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
