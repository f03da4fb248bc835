"""Test-set BLEU command line (counterpart of ``scripts/evaluate_iwslt14.py``):
fp32, W8A8 or W4A8, greedy or beam, with the KV-cached decode of
``serving.decode``.

Modes: ``fp32``; ``int8`` and ``pallas``, SmoothQuant with ``--scales``
(where given) and W8A8 through ``quantize_transformer``, ``pallas`` with
kernel K5 in every linear; ``int4``, packed-int4 payloads and the W4A8 impl,
whose prefill runs K6/K7 at ``quant.w8a8.FUSED_MIN_TOKENS`` (8,192) tokens or
more (the default batch of 128 x 72 is 9,216).  ``--kv-dtype int8`` keeps
the self cache in int8 (the default for ``int8`` and ``pallas``), and
``--fused-attn`` sends its attention to kernel K3.  As the script does, the
sentences go in whole batches of ``--batch-size``: a last partial batch is
left out.  It prints one JSON line (mode, beam, sentences, BLEU with
method4 smoothing and without, seconds, sentences/s).  It runs on the card
unless ``--cpu`` is given; a missing checkpoint raises.

  python -m onnx_transformer_tpu_torch.evaluation --ckpt checkpoints/iwslt14/model_final.npz \\
      --mode pallas --scales onnx_transformer_tpu/artifacts/transformer_scales.npz --fused-attn
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab
from onnx_transformer_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                                           default_linear)


def model_config(vocab_src, vocab_tgt) -> TransformerConfig:
    """The IWSLT14-base configuration over the two vocabularies."""
    return TransformerConfig(len(vocab_src), len(vocab_tgt))


def quantized_impl(model: Transformer, params, mode: str, scales_path=None):
    """(params, linear impl) of ``mode``: the fp32 params and the plain
    linear, SmoothQuant + W8A8 (``int8``, ``pallas``) or W4A8 (``int4``)."""
    if mode in ("int8", "pallas"):
        from onnx_transformer_tpu_torch.quant.smoothquant import load_reference_scales
        from onnx_transformer_tpu_torch.quant.w8a8 import quantize_transformer

        scales = load_reference_scales(scales_path) if scales_path else None
        return quantize_transformer(model, params, scales, mode=mode)
    if mode == "int4":
        from onnx_transformer_tpu_torch.quant.int4 import (make_w4a8_linear_impl,
                                                           quantize_model_params_int4)

        return params, make_w4a8_linear_impl(quantize_model_params_int4(model, params))
    return params, default_linear


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m onnx_transformer_tpu_torch.evaluation")
    ap.add_argument("--data", default="reference/data")
    ap.add_argument("--split", default="test")
    ap.add_argument("--ckpt", default="checkpoints/iwslt14/model_final.npz")
    ap.add_argument("--mode", choices=["fp32", "int8", "pallas", "int4"], default="fp32")
    ap.add_argument("--scales", default=None, help="calibrated scales .npz for SmoothQuant")
    ap.add_argument("--kv-dtype", choices=["fp32", "int8"], default=None,
                    help="KV cache dtype (default: int8 for quantized modes)")
    ap.add_argument("--fused-attn", action="store_true",
                    help="kernel K3 for the int8-cache attention")
    ap.add_argument("--beam", type=int, default=0, help="beam size (0 = greedy)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-padding", type=int, default=72)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dump", default=None, help="write 'hyp \\t||\\t ref' lines (test.py format)")
    args = ap.parse_args(argv)

    from onnx_transformer_tpu_torch.data.dataset import collate, load_split, unbpe
    from onnx_transformer_tpu_torch.device import resolve_device
    from onnx_transformer_tpu_torch.evaluation.bleu import corpus_bleu
    from onnx_transformer_tpu_torch.ops.layers import make_src_mask
    from onnx_transformer_tpu_torch.params import load_checkpoint_params
    from onnx_transformer_tpu_torch.serving import decode as D

    device = resolve_device("cpu" if args.cpu else None)
    vs, vt = load_iwslt14_vocab()
    model = Transformer(model_config(vs, vt))
    params = load_checkpoint_params(args.ckpt, device)
    params, lin = quantized_impl(model, params, args.mode, args.scales)

    pairs = load_split(args.data, args.split)
    if args.limit:
        pairs = pairs[: args.limit]
    bsz, ml = args.batch_size, args.max_padding
    kv = args.kv_dtype or ("int8" if args.mode in ("int8", "pallas") else "fp32")

    def decode(src, sm):
        if args.beam:
            return D.beam_decode(model, params, src, sm, ml, beam_size=args.beam, lin=lin,
                                 kv_cache_dtype=kv, fused_attn=args.fused_attn)
        return D.greedy_decode(model, params, src, sm, ml, lin=lin, kv_cache_dtype=kv,
                               fused_attn=args.fused_attn)

    hyps, refs = [], []
    t0 = time.time()
    n_batches = len(pairs) // bsz
    for i in range(n_batches):
        chunk = pairs[i * bsz: (i + 1) * bsz]
        src, _ = collate(chunk, vs, vt, ml)
        src = torch.from_numpy(src).to(device)
        hyps.extend(D.ids_to_tokens(decode(src, make_src_mask(src)), vt))
        refs.extend([[t.split()] for _, t in chunk])
        if i % 10 == 0:
            print(f"batch {i}/{n_batches}", file=sys.stderr, flush=True)
    dt = time.time() - t0

    bleu = corpus_bleu(refs, hyps, smoothing="method4")
    bleu_plain = corpus_bleu(refs, hyps)
    if args.dump:
        with open(args.dump, "w") as f:
            for h, r in zip(hyps, refs):
                f.write(f"{unbpe(h)} \t||\t {unbpe(r[0])}\n")
    print(json.dumps({
        "mode": args.mode,
        "beam": args.beam,
        "sentences": len(hyps),
        "bleu_method4": round(bleu, 4),
        "bleu": round(bleu_plain, 4),
        "seconds": round(dt, 1),
        "sentences_per_sec": round(len(hyps) / dt, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
