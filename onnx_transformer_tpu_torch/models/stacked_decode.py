"""Chunk-staged greedy decode: the serving fast path (port of
``onnx_transformer_tpu/models/stacked_decode.py``).

The decode runs in chunks of C steps.  Within a chunk each step's self-K/V
rows stay "in flight" (a small tensor that grows by one row per step), and
self-attention takes ONE softmax over the score columns of the main cache
and the in-flight rows together, which is the same as attending over a
cache that holds all of them.  At the chunk boundary the C rows land in the
main cache with one slice write per buffer (``flush_inflight``, in place).
With ``segments > 1`` the self-K/V cache grows at segment boundaries instead
of being allocated at ``max_len`` up front, so each segment's steps read only
the prefix that can be valid; the masked tail columns add exact zeros to
the softmax, so the tokens are the same.

Numerics are the W8A8 chain of ``quant/w8a8.py`` with all-int8-operand
attention: the query and the K/V rows are int8 with per-token scales, the
score dot is an exact integer sum, the probabilities are snapped to the
1/127 grid, and ``p . v`` is an f32 product.  The q/k/v projections'
output fake-quant and the cache's re-quantization collapse into one
rounding (``_w8a8_q``), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul_ref
from onnx_transformer_tpu_torch.quant import core as Q

NEG_INF = L.NEG_INF

_ROLES = {
    "self_q": "self_attn.linears.0",
    "self_k": "self_attn.linears.1",
    "self_v": "self_attn.linears.2",
    "self_o": "self_attn.linears.3",
    "src_q": "src_attn.linears.0",
    "src_o": "src_attn.linears.3",
    "ffn1": "feed_forward.w_1",
    "ffn2": "feed_forward.w_2",
}


def _payload(p: dict) -> dict:
    return {"wq": p["wq"], "sw": p["sw"], "b": p["b"]}


def build_stacked(model: Transformer, params: dict, payloads: dict) -> dict:
    """Gather the decoder's parameters and W8A8 payloads per layer.

    ``payloads`` is the name-keyed dict of ``quant/w8a8.quantize_model_params``
    (every decoder linear; ``generator.proj`` optional, else the fp32
    generator).  Each layer also gets ``self_qkv``: q, k and v fused into one
    [D, 3D] int8 weight.  The int32 accumulation is exact, so the fused dot
    equals the three separate ones bit for bit.  It runs on one device: a
    tensor-parallel view of the model is refused."""
    if model.mesh is not None:
        raise ValueError("the chunk-staged decode runs on one device, not over a mesh")
    layers = []
    for i in range(model.cfg.num_layers):
        lp = params["decoder"]["layers"][i]
        entry = {ln: {"scale": lp[ln]["scale"].float(), "bias": lp[ln]["bias"].float()}
                 for ln in ("ln0", "ln1", "ln2")}
        for role, suffix in _ROLES.items():
            entry[role] = _payload(payloads[f"decoder.layers.{i}.{suffix}"])
        entry["self_qkv"] = {
            key: torch.cat([entry["self_q"][key], entry["self_k"][key],
                            entry["self_v"][key]], dim=-1).contiguous()
            for key in ("wq", "sw", "b")}
        layers.append(entry)
    ln_f = params["decoder"]["ln"]
    if "generator.proj" in payloads:
        gen = _payload(payloads["generator.proj"])
    else:
        gen = {"w": params["generator"]["w"].float(),
               "b": params["generator"]["b"].float()}
    return {
        "layers": layers,
        "final_ln": {"scale": ln_f["scale"].float(), "bias": ln_f["bias"].float()},
        "tgt_lut": params["tgt_embed"]["lut"].float(),
        "generator": gen,
    }


def _ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    return L.layer_norm(x, p["scale"], p["bias"])


def _w8a8(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Per-token int8 activation quant + int8 matmul + scale epilogue:
    x [B, Din] f32 -> [B, Dout] f32."""
    sx = Q.act_scale_per_token(x)
    return w8a8_matmul_ref(Q.quantize(x, sx), sx[:, 0], p["wq"], p["sw"], p["b"])


def _quantize_rows(y: torch.Tensor):
    """Per-token quantize -> (int8 [B, D], scale [B])."""
    s = Q.act_scale_per_token(y)
    return Q.quantize(y, s), s[:, 0]


def _w8a8_q(x: torch.Tensor, p: dict):
    """W8A8 linear with its output quantized per token: (int8, scale [B])."""
    return _quantize_rows(_w8a8(x, p))


def _attn_groups(qi: torch.Tensor, sq: torch.Tensor, groups: list,
                 num_heads: int, quantize: bool) -> torch.Tensor:
    """Joint-softmax attention over column groups.

    qi int8 [B, D] and sq f32 [B] are the quantized query; each group holds
    "k"/"v" int8 [B, Tg, D], "ks"/"vs" f32 [B, Tg] and "vis" bool [B, Tg]
    (or None: all visible).  One softmax runs over the concatenated scores.
    Heads are split by a reshape.  The score dot is computed in f32 on
    int8 values, which is exact: each head's sum of dk products of int8s
    stays far below 2^24 (this needs full-f32 matmuls, so TF32 is off).
    Returns the merged-head context [B, D] f32."""
    b, d = qi.shape
    h = num_heads
    dk = d // h
    inv = float(np.float32(1.0 / np.sqrt(dk)))
    qf = qi.float().view(b, h, dk, 1)
    parts = []
    for g in groups:
        tg = g["k"].shape[1]
        kh = g["k"].float().view(b, tg, h, dk).transpose(1, 2)        # [B,H,Tg,dk]
        s32 = torch.matmul(kh, qf)[..., 0].transpose(1, 2)           # [B,Tg,H]
        s = s32 * (sq[:, None, None] * g["ks"][:, :, None] * inv)
        if g.get("vis") is not None:
            s = s.masked_fill(~g["vis"][:, :, None], NEG_INF)
        parts.append(s)
    scores = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    p = torch.softmax(scores, dim=1)
    if quantize:
        p = L.quantize_probs(p)
    ctx = None
    off = 0
    for g in groups:
        tg = g["k"].shape[1]
        pv = p[:, off:off + tg] * g["vs"][:, :, None]                # [B,Tg,H]
        vh = g["v"].float().view(b, tg, h, dk).transpose(1, 2)        # [B,H,Tg,dk]
        c = torch.matmul(pv.transpose(1, 2)[:, :, None, :], vh)[:, :, 0]  # [B,H,dk]
        ctx = c if ctx is None else ctx + c
        off += tg
    return ctx.reshape(b, d)


def _qdot_attn(qi, sq, kq, ks, vq, vs, mask, num_heads: int, quantize: bool):
    """Single-group attention (cross-attention over a fixed cache)."""
    return _attn_groups(qi, sq, [{"k": kq, "ks": ks, "v": vq, "vs": vs, "vis": mask}],
                        num_heads, quantize)


def layer_stack_step_inflight(stacked: dict, cache_layers: list, inflight,
                              x: torch.Tensor, vis_cache: torch.Tensor,
                              vis_stg, smask: torch.Tensor, num_heads: int,
                              quantize: bool):
    """One token through the decoder stack.

    ``cache_layers``: per layer the main int8 self cache (k/v [B,T,D],
    k_scale/v_scale [B,T,1]) and the cross cache (cross_*).  ``inflight``:
    per layer the rows staged earlier in this chunk ({"k","v": [B,j,D] int8,
    "ks","vs": [B,j]}), or None at the chunk's first step.  This step's K/V
    rows are appended to it.  ``vis_stg`` bool [B, j+1] says which staged
    rows, this step's included, each row may see; None means all of them.
    Returns (x [B, D], new inflight)."""
    new_inflight = []
    d = x.shape[-1]
    for lp, lc, fl in zip(stacked["layers"], cache_layers,
                          inflight if inflight is not None else [None] * len(cache_layers)):
        xn = _ln(x, lp["ln0"])
        y3 = _w8a8(xn, lp["self_qkv"])
        qi, sq = _quantize_rows(y3[:, :d])
        kq, ksc = _quantize_rows(y3[:, d:2 * d])
        vq, vsc = _quantize_rows(y3[:, 2 * d:])
        row = {"k": kq[:, None], "v": vq[:, None], "ks": ksc[:, None], "vs": vsc[:, None]}
        fl = row if fl is None else {key: torch.cat([fl[key], row[key]], dim=1)
                                     for key in row}
        groups = [
            {"k": lc["k"], "ks": lc["k_scale"][..., 0], "v": lc["v"],
             "vs": lc["v_scale"][..., 0], "vis": vis_cache},
            {"k": fl["k"], "ks": fl["ks"], "v": fl["v"], "vs": fl["vs"], "vis": vis_stg},
        ]
        ctx = _attn_groups(qi, sq, groups, num_heads, quantize)
        x = x + _w8a8(ctx, lp["self_o"])
        xn = _ln(x, lp["ln1"])
        qi2, sq2 = _w8a8_q(xn, lp["src_q"])
        ctx = _qdot_attn(qi2, sq2, lc["cross_k"], lc["cross_k_scale"][..., 0],
                         lc["cross_v"], lc["cross_v_scale"][..., 0], smask,
                         num_heads, quantize)
        x = x + _w8a8(ctx, lp["src_o"])
        xn = _ln(x, lp["ln2"])
        x = x + _w8a8(torch.relu(_w8a8(xn, lp["ffn1"])), lp["ffn2"])
        new_inflight.append(fl)
    return x, new_inflight


def flush_inflight(cache_layers: list, inflight: list, base: int) -> None:
    """Land a chunk's staged K/V rows in the main cache at ``base`` (in
    place: one [B, C, D] slice write per buffer)."""
    for lc, fl in zip(cache_layers, inflight):
        c = fl["k"].shape[1]
        lc["k"][:, base:base + c] = fl["k"]
        lc["v"][:, base:base + c] = fl["v"]
        lc["k_scale"][:, base:base + c, 0] = fl["ks"]
        lc["v_scale"][:, base:base + c, 0] = fl["vs"]


def embed_token(stacked: dict, cfg, tok: torch.Tensor, pos) -> torch.Tensor:
    """tok [B, 1] -> [B, D] (lut * sqrt(d) + PE) at ``pos``: an int for the
    whole batch, or a [B] tensor of per-row positions (the serving engine
    embeds each slot at its own position)."""
    lut = stacked["tgt_lut"]
    x = lut[tok[:, 0]] * float(np.float32(np.sqrt(cfg.d_model)))
    pe = L.pe_rows(cfg.max_len, cfg.d_model, lut.device)
    return x + pe[pos]


def final_logits(stacked: dict, x: torch.Tensor, log_probs: bool = False) -> torch.Tensor:
    x = _ln(x, stacked["final_ln"])
    gen = stacked["generator"]
    logits = _w8a8(x, gen) if "wq" in gen else L.linear(x, gen["w"], gen["b"])
    return L.log_softmax(logits) if log_probs else logits


def _segment_bounds(n_chunks: int, segments: int, chunk: int) -> list:
    """The step at which each segment ends: the chunks shared out as evenly
    as they go, the earlier segments taking one more."""
    per, extra = divmod(n_chunks, segments)
    bounds, acc = [], 0
    for s in range(segments):
        acc += per + (1 if s < extra else 0)
        bounds.append(acc * chunk)
    return bounds


def _grow(self_layers: list, b: int, t: int, d: int, dev) -> list:
    """Self-K/V buffers of length ``t`` holding the old ones' rows in front
    and zeros after them."""
    out = []
    for old in self_layers:
        new = {"k": torch.zeros((b, t, d), dtype=torch.int8, device=dev),
               "v": torch.zeros((b, t, d), dtype=torch.int8, device=dev),
               "k_scale": torch.zeros((b, t, 1), device=dev),
               "v_scale": torch.zeros((b, t, 1), device=dev)}
        if old is not None:
            for key, buf in new.items():
                buf[:, :old[key].shape[1]] = old[key]
        out.append(new)
    return out


@torch.no_grad()
def greedy_decode_chunked(model: Transformer, params, stacked: dict,
                          src: torch.Tensor, src_mask: torch.Tensor, max_len: int,
                          chunk: int = 8, start_symbol: int = 0, lin=None,
                          stop_at_eos: bool = True, segments: int = 1) -> torch.Tensor:
    """Lockstep greedy decode with chunk-staged cache writes -> int32
    [B, max_len], the first column ``start_symbol``.  ``max_len`` must be
    divisible by ``chunk``.  With ``stop_at_eos`` a row emits PAD after its
    EOS.  ``segments > 1`` grows the self-K/V cache at that many segment
    boundaries (same tokens)."""
    if max_len % chunk:
        raise ValueError(f"max_len {max_len} must be divisible by chunk {chunk}")
    cfg = model.cfg
    lin = lin or default_linear
    b = src.shape[0]
    dev = src.device
    n_chunks = max_len // chunk
    segments = max(1, min(segments, n_chunks))
    memory = model.encode(params, src, src_mask, lin=lin)
    cross_layers = model.cross_kv(params, memory, lin=lin, cache_dtype="int8")
    smask = src_mask[:, 0, :] if src_mask.ndim == 3 else src_mask
    h, quant = cfg.num_heads, cfg.quantize_attn_probs
    # C columns of scratch past max_len take the last chunk's overhang
    ys = torch.full((b, max_len + chunk), cfg.pad_id, dtype=torch.int32, device=dev)
    ys[:, 0] = start_symbol
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    last = ys[:, 0]
    self_layers = [None] * len(cross_layers)
    prev_end = 0
    for seg_end in _segment_bounds(n_chunks, segments, chunk):
        self_layers = _grow(self_layers, b, seg_end, cfg.d_model, dev)
        cache_layers = [dict(cl, **sl) for cl, sl in zip(cross_layers, self_layers)]
        pos_t = torch.arange(seg_end, device=dev)
        for base in range(prev_end, seg_end, chunk):
            vis_cache = (pos_t < base)[None, :].expand(b, seg_end)
            inflight = None
            outs = []
            for j in range(chunk):
                x = embed_token(stacked, cfg, last[:, None], base + j)
                x, inflight = layer_stack_step_inflight(
                    stacked, cache_layers, inflight, x, vis_cache, None, smask, h, quant)
                nxt = torch.argmax(final_logits(stacked, x), dim=-1).to(torch.int32)
                if stop_at_eos:
                    nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_id), nxt)
                    finished = finished | (nxt == cfg.eos_id)
                outs.append(nxt)
                last = nxt
            ys[:, base + 1:base + 1 + chunk] = torch.stack(outs, dim=1)
            flush_inflight(cache_layers, inflight, base)
        prev_end = seg_end
    return ys[:, :max_len]
