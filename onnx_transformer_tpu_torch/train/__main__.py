"""Train the IWSLT14 model (counterpart of ``scripts/train_iwslt14.py``).

The reference's architecture (N=6, d_model 512, d_ff 2048, 8 heads,
dropout 0.3), loss and schedule (label smoothing 0.1, Noam warmup) and
batching (128 x 72).  As in the JAX script, the IWSLT14 train split is
missing from the reference data, so it trains on the valid split and holds
out the test split for BLEU; ``--train-src/--train-tgt`` (and
``--test-src/--test-tgt``) train on any line-aligned pair of files,
``--build-vocab`` builds the vocabularies from them, and ``--corpus
wmt14|multi30k`` takes the port's corpus loaders.

Every epoch prints one JSON line (loss per token, tokens/s, seconds; the
test BLEU of 512 sentences on the ``--eval-every`` cadence), and
``model_final.npz`` (the whole train state, the JAX package's keys) is
written on that cadence and after the last epoch; ``--resume`` continues
from it.  The end prints the test set's BLEU and writes the params alone to
``params_final.npz``.  ``--qat`` trains through the fake-quant linear,
``--dtype bf16`` computes in bf16 over f32 master weights.  Training runs
no kernel: its products are plain ``torch.matmul``.

Parallel runs, one process per rank:

- ``--pipeline STAGES``: GPipe over a (data, pipe, model) mesh
  (``parallel/pipeline.py``), ``--pipeline-micro`` microbatches a step and
  ``--pipeline-model`` tensor-parallel ranks in a stage.  Where the JAX
  script runs one program over the host's devices, this command spawns the
  ranks (``parallel.launch``): one a card over nccl, data = cards / (STAGES
  x model), or STAGES x model gloo ranks under ``--cpu``.  The checkpoints
  hold the whole state in the one-process layout (the layers unstacked), so
  the other command lines read them.  ``--dtype bf16`` warns and trains
  fp32, as the script does.
- ``--coordinator host:port --num-processes N --process-id i``: data
  parallelism over N processes started by the caller, each loading its
  shard of the corpus (trimmed to equal shards) and holding the whole
  state, replicated from process 0; only process 0 prints and saves.
  Not together with ``--pipeline``.

It runs on the card unless ``--cpu`` is given.

  python -m onnx_transformer_tpu_torch.train --epochs 60 --out checkpoints/iwslt14
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab
from onnx_transformer_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                                           default_linear)


def model_config(vocab_src, vocab_tgt) -> TransformerConfig:
    """The IWSLT14-base configuration over the two vocabularies (the JAX
    script's ``scan_layers=True``; the port's layers run one loop either
    way)."""
    return TransformerConfig(len(vocab_src), len(vocab_tgt), scan_layers=True)


def evaluate_bleu(model, params, pairs, vs, vt, max_padding, batch_size=128, limit=512):
    """Corpus BLEU (method4) of the greedy decode of the first ``limit``
    pairs, in whole batches of ``batch_size``: fewer pairs than a batch
    decode nothing, as in the script."""
    from onnx_transformer_tpu_torch.data.dataset import collate
    from onnx_transformer_tpu_torch.evaluation.bleu import corpus_bleu
    from onnx_transformer_tpu_torch.ops.layers import make_src_mask
    from onnx_transformer_tpu_torch.params import tree_leaves
    from onnx_transformer_tpu_torch.serving import decode as D

    dev = tree_leaves(params)[0].device
    pairs = pairs[:limit]
    hyps, refs = [], []
    for i in range(0, len(pairs) - batch_size + 1, batch_size):
        chunk = pairs[i: i + batch_size]
        src, _ = collate(chunk, vs, vt, max_padding)
        src = torch.from_numpy(src).to(dev)
        ys = D.greedy_decode(model, params, src, make_src_mask(src), max_padding, 0)
        hyps.extend(D.ids_to_tokens(ys, vt))
        refs.extend([[t.split()] for _, t in chunk])
    return corpus_bleu(refs, hyps, smoothing="method4")


def load_corpus(args):
    """(train pairs, test pairs, source vocabulary, target vocabulary), as
    the script's corpus flags choose them; a built vocabulary is saved to
    ``<out>/vocab.json``."""
    from onnx_transformer_tpu_torch.data.dataset import load_pairs, load_split, tokenize
    from onnx_transformer_tpu_torch.data.vocab import build_vocab, save_vocab

    vs = vt = None
    if args.corpus == "wmt14":
        from onnx_transformer_tpu_torch.data.corpora import (build_wmt14_vocab,
                                                             load_wmt14_pairs, tokenize_pairs)

        raw_train = load_wmt14_pairs("train", limit=args.wmt14_limit)
        raw_test = load_wmt14_pairs("test", limit=512)
        vs, vt = build_wmt14_vocab(raw_train)
        train_pairs = tokenize_pairs(raw_train)
        test_pairs = tokenize_pairs(raw_test)
        os.makedirs(args.out, exist_ok=True)
        save_vocab(vs, vt, os.path.join(args.out, "vocab.json"))
    elif args.corpus == "multi30k":
        from onnx_transformer_tpu_torch.data.corpora import load_multi30k_pairs

        train_pairs = load_multi30k_pairs(args.data, "train")
        try:
            test_pairs = load_multi30k_pairs(args.data, "val")
        except FileNotFoundError:
            test_pairs = train_pairs[: min(512, len(train_pairs))]
    elif args.train_src:
        train_pairs = load_pairs(args.train_src, args.train_tgt)
        test_pairs = (load_pairs(args.test_src, args.test_tgt)
                      if args.test_src else train_pairs[: min(512, len(train_pairs))])
    else:
        train_pairs = load_split(args.data, "valid")
        test_pairs = load_split(args.data, "test")
    if args.corpus == "wmt14":
        pass  # the vocabularies come from the wmt14 recipe above
    elif args.build_vocab or args.corpus == "multi30k":
        vs = build_vocab(tokenize(s) for s, _ in train_pairs)
        vt = build_vocab(tokenize(t) for _, t in train_pairs)
        os.makedirs(args.out, exist_ok=True)
        save_vocab(vs, vt, os.path.join(args.out, "vocab.json"))
    else:
        vs, vt = load_iwslt14_vocab()
    return train_pairs, test_pairs, vs, vt


def train(args, cfg: TransformerConfig, vs, vt, train_pairs: list, test_pairs: list,
          device) -> list:
    """The training run of one process: alone, as one rank of a pipeline
    world (``args.pipeline``, under ``parallel.launch``) or as process
    ``args.process_id`` of ``args.num_processes`` (its process group
    already joined).  Returns the epoch lines (on process 0)."""
    from onnx_transformer_tpu_torch.data.dataset import BucketedLoader
    from onnx_transformer_tpu_torch.train import checkpoint as CKPT
    from onnx_transformer_tpu_torch.train import trainer as T

    multiproc = args.num_processes > 1
    model = Transformer(cfg)
    tx = T.make_optimizer(cfg.d_model, base_lr=args.base_lr, warmup=args.warmup)
    state = T.init_state(model, tx, seed=42, device=device).tree()

    os.makedirs(args.out, exist_ok=True)
    ckpt_path = os.path.join(args.out, "model_final.npz")

    lin = default_linear
    if args.qat != "none":
        from onnx_transformer_tpu_torch.quant.int4 import make_qat_linear_impl

        lin = make_qat_linear_impl(w_bits=8 if args.qat == "w8a8" else 4, a_bits=8)

    start_epoch = 0
    resumed = args.resume and os.path.exists(ckpt_path)
    if resumed:
        state = CKPT.restore(ckpt_path, state)
        start_epoch = CKPT.load_meta(ckpt_path).get("epoch", 0) + 1

    mesh = gather = None
    accum = args.accum
    if args.pipeline:
        import torch.distributed as dist

        from onnx_transformer_tpu_torch.parallel import pipeline as PP
        from onnx_transformer_tpu_torch.parallel.mesh import mesh_generator

        need = args.pipeline * args.pipeline_model
        mesh = PP.make_pipeline_mesh(data=dist.get_world_size() // need, pipe=args.pipeline,
                                     model=args.pipeline_model, device=device)
        is_main = dist.get_rank() == 0
        if is_main:
            print(f"pipeline mesh: {{'data': {mesh.data}, 'pipe': {mesh.pipe}, "
                  f"'model': {mesh.model}}}", flush=True)
        state = PP.shard_pipeline_state(
            T.map_state(state, PP.stack_pipeline_params, lambda x: x), mesh)
        if args.dtype == "bf16":
            import warnings

            warnings.warn("--dtype bf16 is not implemented for the pipeline "
                          "schedule; training fp32")
        step_fn = PP.make_pipeline_train_step(model, tx, mesh, n_micro=args.pipeline_micro,
                                              donate=True, lin=lin)
        accum = 1  # microbatching subsumes accumulation
        gen = mesh_generator(1234, mesh)

        def gather(st):
            """The whole state in the one-process layout, on every rank."""
            return T.map_state(st, lambda t: PP.unstack_pipeline_params(
                PP.gather_pipeline_params(t, mesh)), lambda x: x)

        def rows(batch):
            return T.shard_batch(batch, mesh)
    else:
        cdt = torch.bfloat16 if args.dtype == "bf16" else None
        is_main = args.process_id == 0
        if multiproc:
            from onnx_transformer_tpu_torch.parallel import multihost as MH
            from onnx_transformer_tpu_torch.parallel.mesh import make_mesh, mesh_generator

            # equal per-shard batch counts => lockstep steps on every process
            trim = len(train_pairs) // args.num_processes * args.num_processes
            train_pairs = train_pairs[:trim]
            mesh = make_mesh(data=args.num_processes, model=1, device=device)
            state = MH.replicate_tree(state, mesh)
            gen = mesh_generator(1234, mesh)

            def rows(batch):
                return MH.global_batch(batch, mesh)
        else:
            gen = torch.Generator(device=device).manual_seed(1234)

            def rows(batch):
                return batch
        step_fn = T.make_train_step(model, tx, mesh=mesh, accum=accum, donate=True, lin=lin,
                                    compute_dtype=cdt)
    if resumed and is_main:
        print(f"resumed from epoch {start_epoch}", flush=True)

    loader = BucketedLoader(
        train_pairs, vs, vt, batch_size=args.batch_size,
        max_padding=args.max_padding, seed=7,
        num_shards=args.num_processes, shard_index=args.process_id,
        token_budget=args.token_budget,
    )

    def whole(st):
        return st if gather is None else gather(st)

    history = []
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        # the metrics accumulate on the device: one read per epoch
        tot_loss = tot_tok = None
        for batch in T.prefetch(T.batch_to_arrays(b, accum, device) for b in loader):
            state, m = step_fn(state, rows(batch), gen)
            tot_loss = m["loss"] if tot_loss is None else tot_loss + m["loss"]
            tot_tok = m["ntokens"] if tot_tok is None else tot_tok + m["ntokens"]
        tot_loss, tot_tok = float(tot_loss), int(tot_tok)
        dt = time.time() - t0
        lpt = tot_loss / max(tot_tok, 1)
        line = {
            "epoch": epoch,
            "loss_per_token": round(lpt, 4),
            "tokens_per_sec": round(tot_tok / dt, 1),
            "seconds": round(dt, 1),
        }
        evaluate = bool(args.eval_every) and (epoch + 1) % args.eval_every == 0
        save = (epoch + 1) % max(args.eval_every, 1) == 0 or epoch + 1 == args.epochs
        # every rank takes part in gathering a pipeline's state
        full = whole(state) if evaluate or save else None
        if evaluate and is_main:
            bleu = evaluate_bleu(model, full["params"], test_pairs, vs, vt, args.max_padding)
            line["test_bleu"] = round(bleu, 4)
        history.append(line)
        if is_main:
            print(json.dumps(line), flush=True)
        # process 0 alone, as the reference's distributed/iwslt14_train.py:436-438
        if save and is_main:
            CKPT.save_params_with_meta(ckpt_path, full, {"epoch": epoch,
                                                         "config": "iwslt14-base"})

    final_params = whole(state)["params"]
    if not is_main:
        return history
    # the whole test set's BLEU, on process 0
    bleu = evaluate_bleu(model, final_params, test_pairs, vs, vt, args.max_padding,
                         limit=len(test_pairs))
    print(json.dumps({"final_test_bleu": round(bleu, 4)}), flush=True)
    # the params alone, for the inference and quantization command lines
    CKPT.save_params_with_meta(
        os.path.join(args.out, "params_final.npz"),
        final_params,
        {"final_test_bleu": bleu, "epochs": args.epochs},
    )
    return history


def pipeline_rank(args, cfg, vs, vt, train_pairs, test_pairs) -> list:
    """One rank of a ``--pipeline`` world (under ``parallel.launch``)."""
    import torch.distributed as dist

    device = torch.device("cpu")
    if not args.cpu:
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return train(args, cfg, vs, vt, train_pairs, test_pairs, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m onnx_transformer_tpu_torch.train")
    ap.add_argument("--data", default="reference/data")
    # generic parallel-corpus training (the reference's wmt14_train.py /
    # main_train.py / dataloader.py variants): any pre-tokenized line-aligned
    # file pair, optionally with a vocabulary built from it
    ap.add_argument("--train-src", default=None, help="src train file (overrides --data valid split)")
    ap.add_argument("--train-tgt", default=None)
    ap.add_argument("--test-src", default=None)
    ap.add_argument("--test-tgt", default=None)
    ap.add_argument("--build-vocab", action="store_true",
                    help="build vocab from the train files (min_freq 2) instead of the IWSLT14 artifact")
    ap.add_argument("--corpus", choices=["iwslt14", "wmt14", "multi30k"], default="iwslt14",
                    help="wmt14: HF datasets loader + reference vocab recipe "
                         "(wmt14_train.py:212-251); multi30k: parallel-file "
                         "layout at --data (main_train.py trainer's corpus)")
    ap.add_argument("--wmt14-limit", type=int, default=None,
                    help="cap wmt14 train pairs (the full set is 4.5M)")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-padding", type=int, default=72)
    ap.add_argument("--base-lr", type=float, default=1.0)
    ap.add_argument("--warmup", type=int, default=3000)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--token-budget", type=int, default=None,
                    help="token-count batching (reference batch_size_fn, "
                         "train.py:48-58): fixed per-length-bucket batch "
                         "sizes ~budget/len; cuts padding waste ~2-3x")
    ap.add_argument("--out", default="checkpoints/iwslt14")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--qat", choices=["none", "w8a8", "w4a8"], default="none",
                    help="quantization-aware training (STE fake-quant linears)")
    ap.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                    help="bf16: mixed-precision forward/backward with f32 "
                         "master weights + optimizer moments; the reference trains pure fp32")
    ap.add_argument("--pipeline", type=int, default=0, metavar="STAGES",
                    help="GPipe pipeline parallelism over a 'pipe' mesh axis "
                         "(data x pipe x model mesh, one process per rank)")
    ap.add_argument("--pipeline-micro", type=int, default=4,
                    help="microbatches per pipeline step")
    ap.add_argument("--pipeline-model", type=int, default=1,
                    help="TP width inside each pipeline stage")
    ap.add_argument("--cpu", action="store_true")
    # multi-process (multi-host) data parallelism: one process per host with
    # the same command + --coordinator host:port --num-processes N
    # --process-id {0..N-1}; replaces the reference's mp.spawn + NCCL DDP
    # launcher (distributed/iwslt14_train.py:452-466)
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous address host:port (or an init_method URL)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)

    from onnx_transformer_tpu_torch.device import resolve_device
    from onnx_transformer_tpu_torch.parallel.mesh import default_backend

    if args.pipeline and args.num_processes > 1:
        ap.error("--pipeline is one process per rank of one launch: not with --num-processes")
    device = resolve_device("cpu" if args.cpu else None)
    backend = default_backend(device)
    multiproc = args.num_processes > 1
    if multiproc:
        from onnx_transformer_tpu_torch.parallel.mesh import initialize_distributed

        if device.type == "cuda":
            device = torch.device("cuda", args.process_id % torch.cuda.device_count())
            torch.cuda.set_device(device)
        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               backend=backend)
    is_main = args.process_id == 0
    ranks = 1
    if args.pipeline:
        need = args.pipeline * args.pipeline_model
        ranks = torch.cuda.device_count() if device.type == "cuda" else need
        if ranks % need:
            ap.error(f"{ranks} cards are not divisible by pipe x tp = {need}")
    if is_main:
        devices = ([f"cuda:{r}" for r in range(ranks)] if args.pipeline and device.type == "cuda"
                   else [str(device)] * ranks)
        print("devices:", devices, flush=True)

    train_pairs, test_pairs, vs, vt = load_corpus(args)
    if is_main:
        print(f"train pairs {len(train_pairs)}, test pairs {len(test_pairs)}, "
              f"vocab {len(vs)}/{len(vt)}", flush=True)
    cfg = model_config(vs, vt)
    try:
        if args.pipeline:
            from onnx_transformer_tpu_torch.parallel.launch import launch
            # the spawned ranks unpickle pipeline_rank by its module's name,
            # which this module lacks when it runs as __main__
            from onnx_transformer_tpu_torch.train import __main__ as cli

            launch(cli.pipeline_rank, ranks, args, cfg, vs, vt, train_pairs, test_pairs,
                   backend=backend, timeout_s=7 * 24 * 3600.0)
        else:
            train(args, cfg, vs, vt, train_pairs, test_pairs, device)
    finally:
        if multiproc:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
