"""Activation-scale calibration command line for PTQ (counterpart of
``scripts/calibrate.py``).

Runs the trained model over at most ``--num-samples`` + 1 validation batches
(``quant.calibrate.get_act_scales``: the loop stops at a batch count above
it) with input taps on every linear, keeps each one's per-channel absmax on
the device and saves the ``.npz`` that ``smoothquant.load_reference_scales``
and ``quantize_transformer`` read.  No kernel runs: under taps the linears
route around them.  It runs on the card unless ``--cpu`` is given.

  python -m onnx_transformer_tpu_torch.quant --ckpt checkpoints/iwslt14/model_final.npz \\
      --out scales/transformer_scales.npz
"""

from __future__ import annotations

import argparse
import os
import sys

from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab
from onnx_transformer_tpu_torch.models.transformer import Transformer, TransformerConfig


def model_config(vocab_src, vocab_tgt) -> TransformerConfig:
    """The IWSLT14-base configuration over the two vocabularies."""
    return TransformerConfig(len(vocab_src), len(vocab_tgt))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m onnx_transformer_tpu_torch.quant")
    ap.add_argument("--data", default="reference/data")
    ap.add_argument("--ckpt", default="checkpoints/iwslt14/model_final.npz")
    ap.add_argument("--out", default="scales/transformer_scales.npz")
    ap.add_argument("--num-samples", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-padding", type=int, default=128)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from onnx_transformer_tpu_torch.data.dataset import BucketedLoader, load_split
    from onnx_transformer_tpu_torch.device import resolve_device
    from onnx_transformer_tpu_torch.params import load_checkpoint_params
    from onnx_transformer_tpu_torch.quant.calibrate import get_act_scales, save_scales

    device = resolve_device("cpu" if args.cpu else None)
    vs, vt = load_iwslt14_vocab()
    model = Transformer(model_config(vs, vt))
    params = load_checkpoint_params(args.ckpt, device)

    loader = BucketedLoader(
        load_split(args.data, "valid"), vs, vt,
        batch_size=args.batch_size, max_padding=args.max_padding,
        shuffle=False, seed=0,
    )
    scales = get_act_scales(model, params, loader, num_samples=args.num_samples)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_scales(scales, args.out)
    print(f"saved {len(scales)} per-channel scale tensors -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
