"""Serve-format export: ``torch.export`` program bundles (port of
``onnx_transformer_tpu/export/serialize.py``).

Per batch bucket the encoder, the full greedy decode, the prefill (encoder +
``init_cache``) and the KV-cached decode step are each traced by
``torch.export`` at static shapes and saved with ``torch.export.save`` as
``<graph>_b<B>.pt2``, beside ``params.npz`` (the params in the JAX package's
checkpoint keys) and ``manifest.json`` (the JAX package's keys).  The params
are each program's input pytree; the quantized payloads that ``lin``
closes over become the program's constants, as the JAX package bakes them
into its StableHLO.  The Hopper kernels are registered operators
(``torch.ops.otk.*``, ``ops/kernels``), so a program traced under a W8A8
impl in mode ``pallas`` or ``fused``, or with ``fused_attn``, calls them:
on the card they launch the kernels, on the CPU their plain versions.

Differences from the JAX package:

- ``torch.export`` has no loop construct that it keeps, so the greedy
  program is the ``max_len - 1`` steps unrolled; its size and trace time
  grow with ``max_len``;
- a consumer needs ``torch`` and these operator registrations, which
  :func:`load_exported` imports before it loads a program (the JAX
  package's consumer needs only ``jax``);
- the programs run on the device they were traced on: an export runs on
  the device of the params.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.params import tree_leaves


class _Program(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _sorted_keys(tree):
    """``tree`` with every dict's keys in sorted order.  A program's input
    spec records dict keys in order, so the programs are traced and called
    with sorted keys: params or a cache built in another key order (a
    checkpoint's, the JAX package's) fit the same program, as a JAX pytree
    (keys sorted) does."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_keys(v) for v in tree)
    return tree


def _export_fn(fn: Callable, args: tuple, path: str) -> float:
    """Trace ``fn(*args)`` with ``torch.export``, save it to ``path``;
    returns the seconds taken."""
    t0 = time.perf_counter()
    program = torch.export.export(_Program(fn), _sorted_keys(args), strict=False)
    # the example inputs hold the params: the bundle keeps them once, in params.npz
    program.example_inputs = None
    torch.export.save(program, path)
    return time.perf_counter() - t0


@dataclass
class ExportBundle:
    path: str
    seconds: dict = field(default_factory=dict)   # graph file -> export seconds

    def manifest(self, meta: dict):
        with open(os.path.join(self.path, "manifest.json"), "w") as f:
            json.dump(meta, f, indent=2)


def export_model(
    model: Transformer,
    params,
    out_dir: str,
    batch_sizes: Sequence[int] = (1, 8),
    src_len: int = 72,
    max_len: int = 72,
    lin=default_linear,
    mode: str = "fp32",
    kv_cache_dtype: str = "fp32",
    fused_attn: bool = False,
    graphs: Sequence[str] = ("encoder", "greedy", "prefill", "decode_step"),
) -> ExportBundle:
    """Export the encoder, full-greedy, prefill and decode-step programs per
    batch bucket, on the device of ``params``.

    For a quantized export pass the quantized ``lin`` with the
    SmoothQuant-migrated params, and ``mode`` for the manifest.  ``graphs``
    picks the programs (all four by default); the manifest lists what was
    written."""
    from onnx_transformer_tpu_torch.serving.decode import greedy_decode

    cfg = model.cfg
    dev = tree_leaves(params)[0].device
    bundle = ExportBundle(out_dir)
    os.makedirs(out_dir, exist_ok=True)

    def encode_fn(params, src, src_mask):
        return model.encode(params, src, src_mask, lin=lin)

    def greedy_fn(params, src, src_mask):
        return greedy_decode(model, params, src, src_mask, max_len, lin=lin,
                             kv_cache_dtype=kv_cache_dtype, fused_attn=fused_attn)

    # the prefill + decode-step pair: the consumer drives its own token loop
    def prefill_fn(params, src, src_mask):
        memory = model.encode(params, src, src_mask, lin=lin)
        return model.init_cache(params, memory, max_len, lin=lin, cache_dtype=kv_cache_dtype)

    def step_fn(params, cache, tok, pos, src_mask):
        return model.decode_step(params, cache, tok, pos, src_mask, lin=lin,
                                 fused_attn=fused_attn)

    fns = {"encoder": encode_fn, "greedy": greedy_fn, "prefill": prefill_fn}
    written: dict = {g: [] for g in graphs}
    for b in batch_sizes:
        src = torch.full((b, src_len), 4, dtype=torch.int32, device=dev)
        mask = torch.ones((b, 1, src_len), dtype=torch.bool, device=dev)
        for g in graphs:
            name = f"{g}_b{b}.pt2"
            if g == "decode_step":
                with torch.no_grad():
                    cache = prefill_fn(params, src, mask)
                args = (params, cache, torch.zeros((b, 1), dtype=torch.int32, device=dev),
                        torch.zeros((b,), dtype=torch.int32, device=dev), mask)
                fn = step_fn
            else:
                args, fn = (params, src, mask), fns[g]
            bundle.seconds[name] = _export_fn(fn, args, os.path.join(out_dir, name))
            written[g].append(name)

    # weights + config manifest, in the JAX package's keys
    from onnx_transformer_tpu_torch.train.checkpoint import save

    save(os.path.join(out_dir, "params.npz"), params)
    bundle.manifest({
        "format": "torch.export",
        "model": "iwslt14-encdec",
        "mode": mode,
        "kv_cache_dtype": kv_cache_dtype,
        "config": {
            "src_vocab_size": cfg.src_vocab_size,
            "tgt_vocab_size": cfg.tgt_vocab_size,
            "num_layers": cfg.num_layers,
            "d_model": cfg.d_model,
            "d_ff": cfg.d_ff,
            "num_heads": cfg.num_heads,
            "quantize_attn_probs": cfg.quantize_attn_probs,
        },
        "src_len": src_len,
        "max_len": max_len,
        "batch_buckets": list(batch_sizes),
        "graphs": written,
        "decode_step_signature": (
            "(params, cache, tok[B,1] i32, pos[B] i32, src_mask[B,1,S] bool)"
            " -> (log_probs[B,V] f32, cache); cache pytree comes from prefill"
        ),
    })
    return bundle


class LoadedProgram:
    """A loaded ``torch.export`` program; ``call(*args)`` runs it."""

    def __init__(self, program, name: str = ""):
        self.program = program
        self.name = name
        self._module = program.module()

    def call(self, *args):
        return self._module(*_sorted_keys(args))


def load_exported(path: str, graph: str) -> LoadedProgram:
    """Load an exported program of a bundle.  The package's operator
    registrations (the kernels) are imported first: a program that calls
    them cannot load without them."""
    from onnx_transformer_tpu_torch.ops.kernels import decode_attention, w8a8_matmul  # noqa: F401

    return LoadedProgram(torch.export.load(os.path.join(path, graph)), graph)


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)
