"""Greedy and beam decoding over the KV cache (port of
``onnx_transformer_tpu/serving/decode.py``).

Each token loop is a plain Python loop over ``Transformer.decode_step``;
the JAX package's ``lax.scan``/``while_loop`` programs (and its
``greedy_decode_jit``) have no counterpart.  Every entry point runs on the
device of its ``src`` tensor; a ``src`` that is not a tensor goes to the
card (``device.resolve_device``).

Over a mesh (``model`` a tensor-parallel view, ``Transformer(cfg,
mesh=mesh)``, with its rank's parameter slices and a linear impl made for
the mesh), every rank is given the whole batch, decodes its ``data`` rank's
rows, and returns every row, gathered over ``data``.  ``fused_attn`` is not
taken over a mesh (a warning says so), as the JAX engine does not take it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from onnx_transformer_tpu_torch.device import resolve_device
from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.parallel.mesh import gather_rows, local_rows


def _on_device(model, src, src_mask):
    """``src`` and its mask on one device, cut to this data rank's rows."""
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(np.asarray(src), device=resolve_device())
    src_mask = torch.as_tensor(src_mask, device=src.device)
    return local_rows(src, model.mesh), local_rows(src_mask, model.mesh)


def mesh_fused_attn(model: Transformer, fused_attn: bool) -> bool:
    """``fused_attn``, unless ``model`` is a tensor-parallel view: there the
    int8-cache attention runs in PyTorch, as the JAX engine falls back
    under a mesh (its Pallas call would gather the sharded cache)."""
    if fused_attn and model.mesh is not None:
        warnings.warn("fused_attn is not taken under a tensor-parallel mesh: the int8 cache "
                      "attention runs in PyTorch on each rank's heads", stacklevel=3)
        return False
    return fused_attn


def _time_major(lin, kv_cache_dtype: str, fused_attn: bool, kv_time_major: bool) -> bool:
    """The time-major int8 cache is taken only where its attention exists:
    the non-fused int8 path under a linear impl whose q sits on the int8
    grid."""
    return (kv_time_major and kv_cache_dtype == "int8" and not fused_attn
            and getattr(lin, "quantized_output_grid", False))


def _greedy(model, params, src, src_mask, max_len, start_symbol, lin, stop_at_eos,
            kv_cache_dtype, fused_attn, kv_time_major, early_exit):
    cfg = model.cfg
    src, src_mask = _on_device(model, src, src_mask)
    b, dev = src.shape[0], src.device
    fused_attn = mesh_fused_attn(model, fused_attn)
    tm = _time_major(lin, kv_cache_dtype, fused_attn, kv_time_major)
    memory = model.encode(params, src, src_mask, lin=lin)
    cache = model.init_cache(params, memory, max_len, lin=lin, cache_dtype=kv_cache_dtype,
                             time_major=tm)
    ys = torch.full((b, max_len), cfg.pad_id, dtype=torch.int32, device=dev)
    ys[:, 0] = start_symbol
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    last = ys[:, 0]
    for i in range(max_len - 1):
        if early_exit and bool(finished.all()):
            break
        # raw logits: argmax is the same as on the log-probabilities
        logits, cache = model.decode_step(params, cache, last[:, None], i, src_mask,
                                          lin=lin, fused_attn=fused_attn,
                                          log_probs=False, time_major=tm)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if stop_at_eos:
            nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_id), nxt)
            finished = finished | (nxt == cfg.eos_id)
        ys[:, i + 1] = nxt
        last = nxt
    return gather_rows(ys, model.mesh)


@torch.no_grad()
def greedy_decode(model: Transformer, params, src, src_mask, max_len: int,
                  start_symbol: int = 0, lin=default_linear, stop_at_eos: bool = True,
                  kv_cache_dtype: str = "fp32", fused_attn: bool = False,
                  kv_time_major: bool = False) -> torch.Tensor:
    """Batched greedy decode -> int32 token ids [B, max_len], the first
    column ``start_symbol``.  With ``stop_at_eos`` a row emits PAD after its
    first EOS.  ``kv_cache_dtype="int8"`` keeps the self cache as per-token
    int8 rows (lossless under a W8A8 impl); ``fused_attn`` sends each
    single-query step over an int8 cache to kernel K3; ``kv_time_major``
    stores the int8 cache [T, B, D] (non-fused int8 path only)."""
    return _greedy(model, params, src, src_mask, max_len, start_symbol, lin, stop_at_eos,
                   kv_cache_dtype, fused_attn, kv_time_major, early_exit=False)


@torch.no_grad()
def greedy_decode_early_exit(model: Transformer, params, src, src_mask, max_len: int,
                             start_symbol: int = 0, lin=default_linear,
                             kv_cache_dtype: str = "fp32", fused_attn: bool = False,
                             kv_time_major: bool = False) -> torch.Tensor:
    """:func:`greedy_decode` (with the EOS stop) that ends its loop once
    every row has emitted EOS; the same tokens, fewer steps.  Reading the
    ``finished`` flags waits for the device once per step."""
    return _greedy(model, params, src, src_mask, max_len, start_symbol, lin, True,
                   kv_cache_dtype, fused_attn, kv_time_major, early_exit=True)


@torch.no_grad()
def greedy_decode_nocache(model: Transformer, params, src, src_mask, max_len: int,
                          start_symbol: int = 0, lin=default_linear) -> torch.Tensor:
    """Parity oracle: the whole decoder re-run for every token, no cache and
    no EOS stop."""
    src, src_mask = _on_device(model, src, src_mask)
    memory = model.encode(params, src, src_mask, lin=lin)
    ys = torch.full((src.shape[0], 1), start_symbol, dtype=torch.int32, device=src.device)
    for _ in range(max_len - 1):
        tgt_mask = L.make_tgt_mask(ys, pad=-1)    # no PAD in ys: causal only
        h = model.decode(params, memory, src_mask, ys, tgt_mask, lin=lin)
        logits = model.generate(params, h[:, -1], lin=lin, log_probs=False)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        ys = torch.cat([ys, nxt], dim=1)
    return gather_rows(ys, model.mesh)


def _top_k_stable(x: torch.Tensor, k: int):
    """The k largest of each row, ties broken toward the lower index, as
    ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@torch.no_grad()
def beam_decode(model: Transformer, params, src, src_mask, max_len: int,
                beam_size: int = 4, start_symbol: int = 0, length_penalty: float = 0.6,
                lin=default_linear, kv_cache_dtype: str = "fp32",
                fused_attn: bool = False) -> torch.Tensor:
    """Batched beam search -> the best hypothesis per row, int32 [B, max_len].

    Beams ride the batch dimension; scores are normalised by the GNMT length
    penalty ``((5 + len) / 6) ** length_penalty``."""
    cfg = model.cfg
    src, src_mask = _on_device(model, src, src_mask)
    b, dev = src.shape[0], src.device
    fused_attn = mesh_fused_attn(model, fused_attn)
    k = beam_size
    memory = model.encode(params, src, src_mask, lin=lin)
    mem_k = memory.repeat_interleave(k, dim=0)
    mask_k = src_mask.repeat_interleave(k, dim=0)
    cache = model.init_cache(params, mem_k, max_len, lin=lin, cache_dtype=kv_cache_dtype)
    ys = torch.full((b * k, max_len), cfg.pad_id, dtype=torch.int32, device=dev)
    ys[:, 0] = start_symbol
    # only beam 0 of each row is live at the first step
    scores = torch.tensor([0.0] + [-1e9] * (k - 1), device=dev).repeat(b)
    finished = torch.zeros(b * k, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None] * k
    for i in range(max_len - 1):
        logp, cache = model.decode_step(params, cache, ys[:, i][:, None], i, mask_k,
                                        lin=lin, fused_attn=fused_attn)
        v = logp.shape[-1]
        # finished beams extend only with PAD, at no cost
        pad_only = torch.full((b * k, v), -1e9, device=dev)
        pad_only[:, cfg.pad_id] = 0.0
        logp = torch.where(finished[:, None], pad_only, logp)
        cand = (scores[:, None] + logp).reshape(b, k * v)
        top_scores, top_idx = _top_k_stable(cand, k)
        tok = (top_idx % v).to(torch.int32).reshape(-1)
        flat_src = (rows + top_idx // v).reshape(-1)
        ys = ys[flat_src]
        ys[:, i + 1] = tok
        # every beam of a row holds the same cross-K/V rows: no gather needed
        cache = {"layers": [{key: (val if key.startswith("cross_") else val[flat_src])
                             for key, val in lc.items()} for lc in cache["layers"]]}
        finished = finished[flat_src] | (tok == cfg.eos_id)
        scores = top_scores.reshape(-1)
    lengths = (ys != cfg.pad_id).sum(dim=1).float()
    norm = (scores / ((5.0 + lengths) / 6.0) ** length_penalty).reshape(b, k)
    best = torch.argmax(norm, dim=1)
    return gather_rows(ys.reshape(b, k, max_len)[torch.arange(b, device=dev), best], model.mesh)


def ids_to_tokens(ids, vocab, eos_id: int = 1, pad_id: int = 2) -> list[list[str]]:
    """Strip BOS, cut at the first EOS, drop PADs: BPE token lists."""
    out = []
    for row in np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids):
        toks = []
        for t in row[1:]:
            if t == eos_id:
                break
            if t == pad_id:
                continue
            toks.append(vocab.itos[int(t)])
        out.append(toks)
    return out
