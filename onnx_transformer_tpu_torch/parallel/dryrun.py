"""Entry points of the parallel paths (port of the JAX package's
``__graft_entry__.py``): a one-device forward check and the multi-rank dry
run.

- :func:`entry` -> (fn, example_args): the forward (log-probs) of the
  IWSLT14-base model at its real widths, weights from a seed.
- :func:`dryrun_multichip` runs on each rank of a world of ``n`` and makes
  the JAX dry run's four steps under the same conditions: one dp x tp train
  step over a (data, model) mesh; one dp x pp x tp (+SP) pipelined train
  step over ``make_pipeline_mesh(data=n // 4, pipe=2, model=2)`` where 8
  divides ``n``; the tensor-parallel serving engine at 6 layers with twice
  its slots of requests; the fault campaign with its sources split over
  ``data``.  Rank 0 prints a line per step ("... OK"), then each step's
  seconds and collectives (calls and host seconds) on a line of their own.

    python -m onnx_transformer_tpu_torch.parallel.dryrun N [--platform cpu]

launches N ranks (``parallel.launch``): nccl with a card per rank, or gloo
on the CPU with ``--platform cpu``.  The widths are IWSLT14-base's unless a
``cfg`` is given (the tests run it narrow).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from onnx_transformer_tpu_torch.data.dataset import Batch
from onnx_transformer_tpu_torch.device import resolve_device
from onnx_transformer_tpu_torch.inject import campaign as CAM
from onnx_transformer_tpu_torch.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.parallel import collectives as PC
from onnx_transformer_tpu_torch.parallel import pipeline as PP
from onnx_transformer_tpu_torch.parallel.launch import launch
from onnx_transformer_tpu_torch.parallel.mesh import make_mesh, mesh_generator
from onnx_transformer_tpu_torch.params import params_from_jax
from onnx_transformer_tpu_torch.quant.w8a8 import quantize_transformer
from onnx_transformer_tpu_torch.serving.engine import TranslationEngine
from onnx_transformer_tpu_torch.train import trainer as T

IWSLT14 = TransformerConfig(src_vocab_size=5337, tgt_vocab_size=4444)


def _params(model: Transformer, seed: int, weights: Optional[dict], device) -> dict:
    """Weights from ``seed``, or ``weights[seed]`` (a JAX-layout tree of
    arrays) where given."""
    if weights is not None and seed in weights:
        return params_from_jax(weights[seed], device=device)
    return model.init(seed, device)


def entry(device=None):
    """(fn, example_args) of the IWSLT14-base forward at its real widths."""
    model = Transformer(IWSLT14)
    dev = resolve_device(device)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    b, s, t = 8, 24, 16
    src = rng.integers(4, IWSLT14.src_vocab_size, (b, s)).astype(np.int32)
    src[:, -2:] = IWSLT14.pad_id
    tgt_in = rng.integers(4, IWSLT14.tgt_vocab_size, (b, t)).astype(np.int32)
    src, tgt_in = torch.from_numpy(src).to(dev), torch.from_numpy(tgt_in).to(dev)

    def fn(params, src, tgt_in, src_mask, tgt_mask):
        return model.forward_logits(params, src, tgt_in, src_mask, tgt_mask)

    return fn, (params, src, tgt_in, L.make_src_mask(src), L.make_tgt_mask(tgt_in))


class _Vocab:
    def __init__(self, n: int):
        self.itos = ["<s>", "</s>", "<blank>", "<unk>"] + [f"t{i}" for i in range(n - 4)]


def dryrun_multichip(n_devices: int, cfg: Optional[TransformerConfig] = None,
                     weights: Optional[dict] = None, device=None) -> dict:
    """The dry run on this rank of a world of ``n_devices`` (module
    docstring).  ``weights`` maps a seed to a JAX-layout tree of arrays used
    in place of the port's weights from that seed.  Returns the printed
    lines and each step's figures."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"the dry run of {n_devices} ranks runs in a world of "
                         f"{dist.get_world_size()}")
    cfg = cfg or IWSLT14
    out = {"lines": [], "seconds": {}, "collectives": {}}

    def say(line: str) -> None:
        out["lines"].append(line)
        if dist.get_rank() == 0:
            print(line, flush=True)

    def timed(label: str, fn):
        """fn() on every rank with its host seconds (the device waited for)
        and its collectives recorded under ``label``."""
        PC.reset_counts()
        sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["seconds"][label] = time.perf_counter() - t0
        out["collectives"][label] = {c.__name__: (c.calls, round(c.seconds, 6))
                                     for c in PC.COLLECTIVES if c.calls}
        return res

    model = Transformer(cfg)
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(data=n_devices // model_axis, model=model_axis, device=device)
    dev = mesh.device
    say(f"mesh: {{'data': {mesh.data}, 'model': {mesh.model}}}")

    tx = T.make_optimizer(cfg.d_model)
    params = _params(model, 0, weights, dev)
    state = T.shard_state(T.TrainState(params, tx.init(params), torch.zeros(
        (), dtype=torch.int32, device=dev)).tree(), mesh)
    rng = np.random.default_rng(1)
    b, s = n_devices // model_axis * 2, 12
    src = rng.integers(4, cfg.src_vocab_size, (b, s)).astype(np.int32)
    tgt = rng.integers(4, cfg.tgt_vocab_size, (b, s)).astype(np.int32)
    tgt[:, 0] = cfg.bos_id
    arrs = T.shard_batch(T.batch_to_arrays(Batch.make(src, tgt), device=dev), mesh)
    step = T.make_train_step(model, tx, mesh=mesh, donate=False)
    state, metrics = timed("dp x tp", lambda: step(state, arrs, mesh_generator(2, mesh)))
    loss = float(metrics["loss"]) / max(int(metrics["ntokens"]), 1)
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss in the sharded train step")
    out["dp_tp_loss"] = float(metrics["loss"])
    say(f"dryrun_multichip({n_devices}): dp x tp loss/token {loss:.4f} OK")

    if n_devices >= 8 and n_devices % 8 == 0:
        mesh3 = PP.make_pipeline_mesh(data=n_devices // 4, pipe=2, model=2, device=device)
        say(f"mesh: {{'data': {mesh3.data}, 'pipe': {mesh3.pipe}, 'model': {mesh3.model}}}")
        stacked = PP.stack_pipeline_params(_params(model, 3, weights, dev))
        pstate = PP.shard_pipeline_state(
            {"params": stacked, "opt_state": tx.init(stacked),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}, mesh3)
        b2 = max(b, 2 * (n_devices // 4))
        src2 = rng.integers(4, cfg.src_vocab_size, (b2, s)).astype(np.int32)
        tgt2 = rng.integers(4, cfg.tgt_vocab_size, (b2, s)).astype(np.int32)
        tgt2[:, 0] = cfg.bos_id
        arrs2 = T.shard_batch(T.batch_to_arrays(Batch.make(src2, tgt2), device=dev), mesh3)
        pstep = PP.make_pipeline_train_step(model, tx, mesh3, n_micro=2, donate=False)
        pstate, pm = timed("dp x pp x tp", lambda: pstep(pstate, arrs2,
                                                          mesh_generator(4, mesh3)))
        ploss = float(pm["loss"]) / max(int(pm["ntokens"]), 1)
        if not np.isfinite(ploss):
            raise AssertionError("non-finite loss in the pipelined train step")
        out["pp_loss"], out["pp_ntokens"] = float(pm["loss"]), int(pm["ntokens"])
        say(f"dryrun_multichip({n_devices}): dp x pp x tp (+sp) loss/token {ploss:.4f} OK")

    # the engine over the mesh at full depth (6 layers), weights and the KV
    # cache sharded over model, twice its slots of requests
    smodel = Transformer(cfg.with_(num_layers=6))
    s_params = _params(smodel, 5, weights, dev)
    n_slots = max(4, 2 * (n_devices // model_axis))
    eng = TranslationEngine(smodel, s_params, num_slots=n_slots, src_len=s, max_len=10,
                            chunk_steps=4, mesh=mesh)
    src_e = np.random.default_rng(9).integers(4, cfg.src_vocab_size,
                                              (2 * n_slots, s)).astype(np.int32)
    reqs = [eng.submit(r) for r in src_e]
    done = timed("engine", eng.run)
    if len(done) != len(reqs):
        raise AssertionError("the engine lost requests on the mesh")
    out["engine_requests"] = len(done)
    say(f"dryrun_multichip({n_devices}): tp-sharded serving engine 6 layers x {n_slots} "
        f"slots, {len(done)} requests OK")

    # the fault campaign with its sources split over data, the model replicated
    sp, lin8 = quantize_transformer(smodel, s_params, mode="int8")
    nb = n_devices // model_axis
    src_c = torch.from_numpy(src_e[:nb]).to(dev)
    specs = [CAM.FaultSpec("encoder.layers.0.self_attn.linears.0", "WEIGHT", bit=6),
             CAM.FaultSpec("decoder.layers.1.feed_forward.w_1", "INPUT", bit=5, element=2)]
    res = timed("campaign", lambda: CAM.run_campaign(
        smodel, sp, lin8.payloads, specs, src_c, L.make_src_mask(src_c), [["t1", "t2"]] * nb,
        _Vocab(cfg.tgt_vocab_size), max_len=8, fanout=2, mesh=mesh))
    if len(res.rows) != len(specs) * nb:
        raise AssertionError("campaign row count mismatch")
    out["campaign_rows"] = res.rows
    say(f"dryrun_multichip({n_devices}): mesh campaign {len(res.rows)} result rows OK")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}) on {dev}: seconds by step "
              f"{ {k: round(v, 6) for k, v in out['seconds'].items()} }, collectives (calls, "
              f"host s) by step {out['collectives']}", flush=True)
    return out


def _rank(n: int, platform: str) -> dict:
    """One rank of the command line's dry run."""
    device = "cpu"
    if platform != "cpu":
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return dryrun_multichip(n, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8)")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: nccl, a card per rank; cpu: gloo ranks on the CPU")
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds for the run")
    args = ap.parse_args(argv)
    if args.platform == "gpu" and torch.cuda.device_count() < args.n:
        print(f"dryrun: {args.n} ranks need {args.n} cards, {torch.cuda.device_count()} "
              "found (--platform cpu runs them on the CPU)", file=sys.stderr)
        return 1
    launch(_rank, args.n, args.n, args.platform,
           backend="gloo" if args.platform == "cpu" else "nccl", timeout_s=args.timeout)
    return 0


if __name__ == "__main__":
    from onnx_transformer_tpu_torch.parallel.dryrun import main as _main

    sys.exit(_main())
