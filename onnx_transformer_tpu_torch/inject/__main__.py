"""Fault-injection campaign command line (counterpart of
``scripts/campaign.py``, the reference's ``experiment.sh``).

Sweeps targets x fault models x bit positions against the W8A8 model
(SmoothQuant with ``--scales`` where given) and writes the results CSV:
``--csv-format full`` (``layer,golden_bleu,faulty_bleu,bit,fault_model``
with a header) or ``reference`` (the reference's headerless
``node,golden,faulty`` rows).  The targets are the quantized linears of
``--module`` (cut to the first ``--layers-limit``), with
``--attention-targets`` also the attention matmuls, or the descriptors of
``--from-json`` (a reference ``input/*.json`` file, a directory of them, or
a comma-separated list).  Fault sites (element, row, column, seed) are drawn
from ``numpy.random.default_rng(0)`` in the script's order, so a sweep
names the same sites as the JAX script's.  ``--fanout`` is the group size of
``run_campaign``; the port runs a group's experiments one after another.
No kernel runs: under the fault seam every linear and attention routes
around them.  It runs on the card unless ``--cpu`` is given.

  python -m onnx_transformer_tpu_torch.inject --module encoder --sentences 5 \\
      --out results_fault_injection/results.csv
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab
from onnx_transformer_tpu_torch.models.transformer import Transformer, TransformerConfig


def model_config(vocab_src, vocab_tgt) -> TransformerConfig:
    """The IWSLT14-base configuration over the two vocabularies."""
    return TransformerConfig(len(vocab_src), len(vocab_tgt))


def sweep_specs(targets: list, fault_models: list, bits: list, inject_step: int, rng) -> list:
    """The direct sweep: each target x fault model x bit (RANDOM at bit 0
    only), its fault site drawn from ``rng`` in the script's order."""
    from onnx_transformer_tpu_torch.inject.campaign import FaultSpec

    specs = []
    for t in targets:
        for fm in fault_models:
            for bit in bits if fm not in ("RANDOM",) else [0]:
                specs.append(FaultSpec(
                    target=t, fault_model=fm, bit=bit,
                    element=int(rng.integers(0, 512)),
                    row=int(rng.integers(0, 8)), col=int(rng.integers(0, 256)),
                    seed=int(rng.integers(0, 1 << 31)),
                    inject_step=inject_step,
                ))
    return specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m onnx_transformer_tpu_torch.inject")
    ap.add_argument("--data", default="reference/data")
    ap.add_argument("--ckpt", default="checkpoints/iwslt14/model_final.npz")
    ap.add_argument("--scales", default=None)
    ap.add_argument("--module", choices=["encoder", "decoder", "all"], default="encoder")
    ap.add_argument("--fault-models", default="INPUT,WEIGHT,INPUT16,WEIGHT16,RANDOM,RANDOM_BITFLIP")
    ap.add_argument("--bits", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--sentences", type=int, default=5,
                    help="experiments per config (ref: 5 parallel replicas)")
    ap.add_argument("--layers-limit", type=int, default=0)
    ap.add_argument("--inject-step", type=int, default=5)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--out", default="results_fault_injection/results.csv")
    ap.add_argument("--csv-format", default="full", choices=("full", "reference"),
                    help="'reference' = the ref's 3-column headerless node,golden,faulty rows "
                         "(diffable against results_fault_injection/results.csv)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--fanout", type=int, default=16,
                    help="experiments per group of run_campaign (run one after another)")
    ap.add_argument("--from-json", default=None,
                    help="reference input/*.json descriptor file or directory "
                         "(e.g. reference/input/encoder); overrides "
                         "--module target enumeration")
    ap.add_argument("--attention-targets", action="store_true",
                    help="also sweep the attention QK^T/AV bmm targets")
    args = ap.parse_args(argv)

    from onnx_transformer_tpu_torch.data.dataset import collate, load_split
    from onnx_transformer_tpu_torch.device import resolve_device
    from onnx_transformer_tpu_torch.inject import campaign as C
    from onnx_transformer_tpu_torch.ops.layers import make_src_mask
    from onnx_transformer_tpu_torch.params import load_checkpoint_params
    from onnx_transformer_tpu_torch.quant import w8a8 as W

    device = resolve_device("cpu" if args.cpu else None)
    vs, vt = load_iwslt14_vocab()
    cfg = model_config(vs, vt)
    model = Transformer(cfg)
    params = load_checkpoint_params(args.ckpt, device)
    if args.scales:
        from onnx_transformer_tpu_torch.quant.smoothquant import (load_reference_scales,
                                                                  smooth_params)
        params = smooth_params(params, load_reference_scales(args.scales))
    payloads = W.quantize_model_params(model, params)

    fault_models = args.fault_models.split(",")
    bits = [int(b) for b in args.bits.split(",")]

    pairs = load_split(args.data, "test")[: args.sentences]
    src, _ = collate(pairs, vs, vt, args.max_len)
    src = torch.from_numpy(src).to(device)
    sm = make_src_mask(src)
    refs = [t.split() for _, t in pairs]

    rng = np.random.default_rng(0)
    if args.from_json:
        paths = args.from_json.split(",")
        specs = C.specs_from_reference_jsons(
            paths if len(paths) > 1 else paths[0],
            fault_models=fault_models, bit_positions=bits,
            inject_step=args.inject_step)
        for s in specs:  # randomised fault sites, like the direct sweep
            s.element = int(rng.integers(0, 512))
            s.row = int(rng.integers(0, 8))
            s.col = int(rng.integers(0, 256))
        targets = sorted({s.target for s in specs})
        print(f"ingested {args.from_json}: {len(targets)} targets")
    else:
        targets = sorted(payloads)
        if args.attention_targets:
            targets += sorted(C.attention_matmul_names(cfg.num_layers))
        if args.module != "all":
            targets = [t for t in targets if t.startswith(args.module)]
        if args.layers_limit:
            targets = targets[: args.layers_limit]
        specs = sweep_specs(targets, fault_models, bits, args.inject_step, rng)
    print(f"{len(targets)} targets x {len(fault_models)} fault models -> "
          f"{len(specs)} experiments x {len(pairs)} sentences", flush=True)

    t0 = time.time()
    res = C.run_campaign(
        model, params, payloads, specs, src, sm, refs, vt,
        max_len=args.max_len, csv_path=args.out, fanout=args.fanout,
        csv_format=args.csv_format,
        log_fn=lambda s: print(s, flush=True),
    )
    dt = time.time() - t0
    by_model: dict[str, int] = {}
    for r in res.rows:
        if r["faulty_bleu"] < r["golden_bleu"] - 1e-6:
            by_model[r["fault_model"]] = by_model.get(r["fault_model"], 0) + 1
    degraded = sum(by_model.values())
    summary = ", ".join(f"{m} {n}" for m, n in
                        sorted(by_model.items(), key=lambda kv: -kv[1]))
    print(f"done: {len(res.rows)} rows in {dt:.1f}s "
          f"({len(specs) / max(dt, 1e-9):.2f} experiments/s); "
          f"{degraded} rows degraded BLEU ({summary or 'none'}) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
