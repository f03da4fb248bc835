"""Continuous-batching translation engine (port of
``onnx_transformer_tpu/serving/engine.py``).

A fixed pool of decode *slots* stays resident on the device and dead slots
are refilled there, without a round trip to the host:

- admission: the host batch-encodes queued requests (one dispatch per
  source-length *bucket*, padded to the bucket length: masked pad positions
  contribute exact zeros, so this equals full-length encoding) and writes
  their cross-attention K/V, source mask and request tag into a staging
  ring on the device;
- each decode chunk first refills dead slots from the staging ring, then
  advances every slot ``chunk_steps`` steps on the step-synchronous ring
  cache (every row writes its K/V and its output token at the physical
  position ``g % T``; each row's logical window is an age mask), and
  snapshots the rows that finish into a completion buffer on the device;
- the host only enqueues prefill, chunk and report work, and copies a
  report back every few chunks, so the slots never wait on the host.

The slot pool is the batch: ``Transformer.decode_step`` takes a [B] vector
of per-row positions.  A slot's stale self-K/V from its previous occupant
needs no zeroing, since the age mask hides it.

Where the JAX engine threads a donated state through ``jax.jit`` programs,
this one keeps a dict of tensors on the device of ``params`` and updates it
in place under ``torch.no_grad()``; its key names are the JAX state's.
Differences of mechanism, none of them visible in the tokens:

- the global step ``g`` advances by exactly one per decode step, so the
  host mirrors it (``state["g"]`` is a Python int); the ring write position,
  the chunk's first position and every output-ring slice are host ints;
- JAX drops a write by giving it an out-of-range index (``mode="drop"``),
  which on CUDA would be a device-side assert.  Here the staging ring and
  the completion buffer carry one spare last row that padded or surplus
  writes land in and nothing reads, and a refill gathers a staged row for
  every slot and keeps the old row with ``torch.where`` where the slot
  takes nothing;
- a report comes back by a ``non_blocking`` copy into pinned host memory,
  with a CUDA event that says when it has landed, in place of the JAX
  engine's fetcher thread.

Nothing inside a refill or a chunk reads a device value on the host.

Tensor parallelism (``mesh=``, a (data, model) mesh of ``parallel.make_mesh``;
JAX's "BASELINE config 5"): every rank builds the engine from the full
params and linear impl, which it shards itself (``parallel.shard_params``,
``quant.w8a8.shard_linear_impl``: W8A8 or W4A8), and runs the
tensor-parallel view of the model.  A rank's KV cache and staging ring hold its ``d_model / model``
columns (its heads in the fp32 layout); the scales, masks, tags, counters
and output rings are whole on every rank (JAX's ``P()``).  Every rank runs
the same host loop over the same submitted requests and returns the same
``Request``s; to keep the loop's decisions the same on every rank, each
report is waited for as soon as it is fetched.  A mesh takes the general
chunk, drops ``fused_attn`` with a warning (as the JAX engine does) and
refuses beam search.
"""

from __future__ import annotations

import collections
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from onnx_transformer_tpu_torch.models import stacked_decode as SD
from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.parallel.sharding import shard_params
from onnx_transformer_tpu_torch.quant.w8a8 import shard_linear_impl
from onnx_transformer_tpu_torch.serving.decode import _top_k_stable, mesh_fused_attn


@dataclass
class Request:
    req_id: int
    src_ids: np.ndarray            # [S] padded
    out_tokens: list = field(default_factory=list)
    done: bool = False


class EngineStalledError(RuntimeError):
    """Raised by :meth:`TranslationEngine.run` when the device stops
    completing requests.  Carries the requests that did finish before the
    stall in ``done`` so a transient failure loses no results."""

    def __init__(self, msg: str, done: list):
        super().__init__(msg)
        self.done = done


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


class _Fetch:
    """A device tensor on its way to the host: a ``non_blocking`` copy into
    pinned memory and the event recorded behind it (on a CPU tensor, a
    plain copy, ready at once)."""

    def __init__(self, arr: torch.Tensor, kind: str, gen: int):
        self.kind, self.gen = kind, gen
        if arr.is_cuda:
            self.host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            self.host.copy_(arr, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = arr.clone(), None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class TranslationEngine:
    def __init__(
        self,
        model: Transformer,
        params,
        lin: Callable = default_linear,
        num_slots: int = 32,
        src_len: int = 72,
        max_len: int = 72,
        chunk_steps: int = 16,
        kv_cache_dtype: str = "fp32",
        fused_attn: bool = False,
        mesh=None,
        prefill_chunk: int = 8,
        refill_per_step: int = 0,
        stage_capacity: int = 0,
        buckets: Optional[Sequence[int]] = None,
        kv_time_major: bool = False,
        refill_every: int = 6,
        comp_capacity: int = 0,
        beam_size: int = 1,
        length_penalty: float = 0.6,
    ):
        self.mesh = mesh
        if mesh is not None:
            if beam_size > 1:
                raise ValueError("engine beam mode runs on one device: beam_size > 1 takes "
                                 "no mesh")
            model = Transformer(model.cfg, mesh)
            fused_attn = mesh_fused_attn(model, fused_attn)
            params = shard_params(params, mesh)
            lin = shard_linear_impl(lin, mesh)
        self.model = model
        cfg = model.cfg
        # completion rows pack 2 output tokens per int32 (pack_ring)
        if cfg.tgt_vocab_size >= (1 << 16):
            raise ValueError("the engine packs 2 tokens per int32; tgt_vocab_size "
                             "must be < 65536")
        self.lin = lin
        self.B = num_slots
        # slot-group beam search: K consecutive slots serve ONE request's K
        # beams.  Cross-K/V is admitted once per group; the self-KV ring
        # rows are gathered per step by beam ancestry.  beam_size=1 is the
        # greedy engine.
        self.beam = max(1, beam_size)
        self.length_penalty = length_penalty
        if num_slots % self.beam:
            raise ValueError("num_slots must be divisible by beam_size")
        if self.beam > 1 and (fused_attn or kv_time_major):
            raise ValueError("engine beam mode takes the non-fused attention and a "
                             "batch-major cache")
        self.prefill_chunk = max(1, min(prefill_chunk, num_slots))
        self.S = src_len
        self.T = max_len
        self.chunk = chunk_steps
        # fast path: also refill dead slots mid-chunk every this many steps
        # (death-to-refill idle ~ refill_every/2 instead of chunk/2).  The
        # general path refills once per chunk.
        self.refill_every = max(1, refill_every)
        self.kv_dtype = kv_cache_dtype
        # staging-ring capacity and per-step refill budget; the defaults let
        # the ring survive ~2 chunks of pipeline lag at short outputs
        self.U = refill_per_step or max(1, min(num_slots, 32))
        self.R = stage_capacity or max(2 * self.prefill_chunk, num_slots)
        # source-length buckets for prefill (ascending; the last covers S)
        bks = sorted(set(min(self.S, b) for b in (buckets or [self.S])))
        if bks[-1] != self.S:
            bks.append(self.S)
        self.buckets = bks
        self.fused_attn = fused_attn
        # time-major self-KV ring: needs the W8A8 quantized-output grid for
        # exact q recovery in attention
        self._tm = (kv_time_major and kv_cache_dtype == "int8" and not fused_attn
                    and getattr(lin, "quantized_output_grid", False))
        self.params = params
        self.device = params["tgt_embed"]["lut"].device
        self._ids = itertools.count()
        self._queues: dict[int, list[Request]] = {b: [] for b in self.buckets}
        self._inflight: dict[int, Request] = {}
        self._state = None    # device slot state, built at the first run
        self._head = 0        # total requests staged (ring head)
        self._tail_known = 0  # device-confirmed consumed count (lags)
        self._cur_known = 0
        # host-accumulated occupancy integral (the device counters reset at
        # every harvest): live slot-steps and total slot-steps
        self.occ_live_steps = 0
        self.occ_slot_steps = 0
        # refill-loss attribution, from the harvest headers
        self.starved_slots = 0
        self.gated_slots = 0

        B, T, R = self.B, self.T, self.R
        # completion buffer: drained every few chunks, so it absorbs several
        # chunks of deaths plus a full slot pool; refill gates itself off
        # when it nears capacity (backpressure)
        self._C = comp_capacity or max(4 * B, 2 * (B + chunk_steps * self.U))
        self._GWRAP = T * 16384      # global-step wrap (a multiple of T)
        # head/tail staging counters wrap at a large multiple of R so that a
        # server that runs indefinitely never overflows int32; all
        # arithmetic on them is mod-HWRAP differences over windows < R
        self._HWRAP = R * (1 << 16)
        # completion rows carry the output ring packed 2 tokens per int32
        self._PT = (T + 1) // 2
        # report row width: 3 meta + packed ring, at least 6 so the header's
        # starve/gated columns exist at a tiny max_len
        self._HW = max(6, 3 + self._PT)
        self._cross_keys = (("cross_k", "cross_v", "cross_k_scale", "cross_v_scale")
                            if kv_cache_dtype == "int8" else ("cross_k", "cross_v"))

        self._payloads = getattr(lin, "payloads", None) or {}
        # fast chunk: int8 cache and int8 W8A8 payloads on one device, T a
        # multiple of the chunk (a flush never straddles the ring seam).
        # W4A8 impls carry 'wq_packed' (and other numerics), and modes
        # 'fake'/'pallas' keep their own arithmetic: the general chunk
        self._stacked = None
        first = self._payloads.get("decoder.layers.0.self_attn.linears.0")
        if self.beam > 1:
            self._chunk = self._chunk_beam
        elif (kv_cache_dtype == "int8" and mesh is None and not fused_attn and not self._tm
                and chunk_steps >= 1 and T % chunk_steps == 0
                and first is not None and "wq" in first
                and getattr(lin, "mode", "int8") in ("int8", "fused")):
            self._stacked = SD.build_stacked(model, params, self._payloads)
            self._chunk = self._chunk_fast
        else:
            self._chunk = self._chunk_fn

    # ----------------------------------------------------------- device side

    def _pack_ring(self, out_rows: torch.Tensor) -> torch.Tensor:
        """[N, T] int32 tokens -> [N, PT] int32, 2 tokens per word."""
        if self.T % 2:
            out_rows = F.pad(out_rows, (0, 1))
        return out_rows[:, 0::2] | (out_rows[:, 1::2] << 16)

    def _land(self, comp: torch.Tensor, cur: torch.Tensor, died: torch.Tensor,
              entry: torch.Tensor) -> torch.Tensor:
        """Write the ``entry`` rows of ``died`` into ``comp`` at ``cur``,
        ``cur + 1``, ... in order, in place; the other rows, and any past
        the capacity C, land in the spare row C.  Returns the new ``cur``."""
        c = self._C
        drank = _i32(torch.cumsum(died, 0)) - 1
        at = cur + drank
        comp.index_copy_(0, torch.where(died & (at < c), at, c).long(), entry)
        return cur + _i32(died.sum())

    @torch.no_grad()
    def _prefill(self, st: dict, src_rows: torch.Tensor, ring_pos: torch.Tensor,
                 tags: torch.Tensor) -> None:
        """Encode up to ``prefill_chunk`` requests in ONE batched encoder
        dispatch (at the bucket length ``src_rows.shape[1]``) and write their
        cross-K/V, mask and tag into the staging ring.  Padding entries carry
        ring index R: the spare row takes them."""
        cfg = self.model.cfg
        stage = st["stage"]
        sb = src_rows.shape[1]
        mask_b = (src_rows != cfg.pad_id)[:, None, :]                  # [k, 1, Sb]
        memory = self.model.encode(self.params, src_rows, mask_b, lin=self.lin)
        cross = self.model.cross_kv(self.params, memory, lin=self.lin,
                                    cache_dtype=self.kv_dtype)
        for sl, cl in zip(stage["layers"], cross):
            for key, val in cl.items():
                big = sl[key]
                # pad the bucket-length values to S rows (the pad region is
                # masked in attention)
                if sb < self.S:
                    time_ax = 2 if big.ndim == 4 else 1
                    padw = [0, 0] * (val.ndim - 1 - time_ax) + [0, self.S - sb]
                    val = F.pad(val, padw)
                big.index_copy_(0, ring_pos, val)
        k = src_rows.shape[0]
        pad_mask = torch.zeros((k, 1, self.S - sb), dtype=torch.bool, device=self.device)
        stage["src_mask"].index_copy_(0, ring_pos, torch.cat([mask_b, pad_mask], dim=2))
        stage["tag"].index_copy_(0, ring_pos, tags)

    def _refill_slots(self, st: dict, take: torch.Tensor, sidx: torch.Tensor,
                      extra: dict) -> None:
        """Slots with ``take`` load staged entry ``sidx`` (a [B] index into
        the ring, in range for every slot): cross-K/V, mask and tag, then
        ``extra`` {key: value for a taking slot}.  The cache's cross rows
        are written in place; a slot that takes nothing keeps its rows."""
        stage = st["stage"]
        for lc, sl in zip(st["cache"]["layers"], stage["layers"]):
            for key in self._cross_keys:
                buf = lc[key]
                sel = take.view(-1, *([1] * (buf.ndim - 1)))
                torch.where(sel, sl[key][sidx], buf, out=buf)
        st["src_mask"] = torch.where(take[:, None, None], stage["src_mask"][sidx],
                                     st["src_mask"])
        st["tag"] = torch.where(take, stage["tag"][sidx], st["tag"])
        for key, val in extra.items():
            st[key] = torch.where(take, val, st[key])
        st["live"] = st["live"] | take

    def _refill(self, st: dict, head: int) -> None:
        """Dead slots take staged requests in rank order: free slot of rank
        r takes the entry at ``tail + r``, within the budget UC, while the
        ring has entries and the completion buffer has room."""
        B, C = self.B, self._C
        uc = min(B, max(2 * self.U, (self.chunk * B) // 16))
        free = ~st["live"]
        rank = _i32(torch.cumsum(free, 0)) - 1                          # [B]
        avail = torch.remainder(head - st["tail"], self._HWRAP)
        # backpressure: stop refilling when the completion buffer could
        # overflow before the next drain (worst case: all B slots die)
        room = st["cur"] < C - 2 * B
        take = free & (rank < avail) & (rank < uc) & room
        # free slots NOT refilled, split by cause: staging ring empty
        # (starved) vs budget/backpressure (gated)
        unfilled = free & ~take
        st["starve"] = st["starve"] + _i32((unfilled & (rank >= avail)).sum())
        st["gated"] = st["gated"] + _i32((unfilled & (rank < avail)).sum())
        sidx = torch.remainder(st["tail"] + rank.clamp_min(0), self.R).long()
        self._refill_slots(st, take, sidx, {"tok": self.model.cfg.bos_id, "start": st["g"]})
        st["tail"] = torch.remainder(st["tail"] + _i32(take.sum()), self._HWRAP)

    @torch.no_grad()
    def _chunk_fn(self, st: dict, head: int) -> None:
        """Advance the slot pool ``chunk_steps`` steps (general path: any
        cache dtype, time-major, fused_attn, any linear impl): one refill,
        then batched ring steps through ``decode_step``; rows that finish
        are snapshotted into the completion buffer."""
        cfg = self.model.cfg
        self._refill(st, head)
        for _ in range(self.chunk):
            g = st["g"]
            live = st["live"]
            # dead rows carry logical position -1 (age mask empty, PE offset
            # clamped to 0); lives span < T steps, so mod-GWRAP differences
            # recover the logical position exactly
            lpos = torch.where(live, torch.remainder(g - st["start"], self._GWRAP), -1)
            w = g % self.T
            logits, st["cache"] = self.model.decode_step(
                self.params, st["cache"], st["tok"][:, None], lpos, st["src_mask"],
                lin=self.lin, fused_attn=self.fused_attn, log_probs=False,
                ring_index=w, time_major=self._tm)
            nxt = torch.where(live, _i32(torch.argmax(logits, dim=-1)), cfg.pad_id)
            # output tokens ride the same ring: one column write per step
            st["out"][:, w] = nxt
            new_live = live & (nxt != cfg.eos_id) & (lpos + 2 < self.T)
            # snapshot the rows that finished THIS step
            died = live & ~new_live
            entry = torch.cat([st["tag"][:, None], (lpos + 1)[:, None],
                               torch.remainder(st["start"], self.T)[:, None],
                               self._pack_ring(st["out"])], dim=1)
            st["cur"] = self._land(st["comp"], st["cur"], died, entry)
            st.update(tok=torch.where(live, nxt, st["tok"]), live=new_live,
                      occ=st["occ"] + _i32(live.sum()), occ_steps=st["occ_steps"] + 1,
                      g=(g + 1) % self._GWRAP)

    @torch.no_grad()
    def _chunk_fast(self, st: dict, head: int) -> None:
        """Fast chunk (int8 cache, W8A8 int8 payloads): the chunk-staged
        decode of ``models/stacked_decode.py``.  Each step's K/V rows stay
        in flight and join attention as extra softmax columns; per chunk the
        cache takes ONE [B, C, D] write per buffer, the output ring one
        [B, C] write.  Slots are also refilled every ``refill_every`` steps;
        a row's completion entry shows the output ring as it stood at its
        death step (a slot may die, be refilled and die again in one chunk).
        """
        cfg = self.model.cfg
        B, T, dev = self.B, self.T, self.device
        stacked = self._stacked
        self._refill(st, head)
        layers = st["cache"]["layers"]
        g0 = st["g"]
        w0 = g0 % T          # a multiple of the chunk: T % chunk == 0
        pos = torch.arange(T, device=dev)
        out_before = st["out"]
        died_at = torch.full((B,), -1, dtype=torch.int32, device=dev)
        n_final = torch.zeros((B,), dtype=torch.int32, device=dev)
        dead_tag = torch.zeros((B,), dtype=torch.int32, device=dev)
        dead_start = torch.zeros((B,), dtype=torch.int32, device=dev)
        inflight = None
        outs: list = []

        def snap():
            """Land every pending death with its death-time ring image: for
            a row dead since step jd, the columns past jd keep their
            pre-chunk values."""
            died_any = died_at >= 0
            out_snap = out_before
            if outs:
                j = len(outs)
                chunk_out = torch.stack(outs, dim=1)                      # [B, j]
                before = out_before[:, w0:w0 + j]
                upd = torch.where(torch.arange(j, device=dev)[None, :] <= died_at[:, None],
                                  chunk_out, before)
                out_snap = torch.cat([out_before[:, :w0], upd, out_before[:, w0 + j:]], dim=1)
            entry = torch.cat([dead_tag[:, None], n_final[:, None],
                               torch.remainder(dead_start, T)[:, None],
                               self._pack_ring(out_snap)], dim=1)
            st["cur"] = self._land(st["comp"], st["cur"], died_any, entry)

        for j in range(self.chunk):
            if j and j % self.refill_every == 0:
                # mid-chunk refill: land pending deaths first (the slots are
                # about to be re-occupied), then admit
                snap()
                died_at = torch.full((B,), -1, dtype=torch.int32, device=dev)
                st["g"] = (g0 + j) % self._GWRAP
                self._refill(st, head)
            live, tok, start = st["live"], st["tok"], st["start"]
            lpos = torch.where(live, torch.remainder(g0 + j - start, self._GWRAP), -1)
            age = torch.remainder(w0 + j - pos, T)                        # [T]
            # in-chunk positions (age <= j) are stale until the flush; their
            # rows attend through the in-flight columns instead
            vis_cache = (age[None, :] > j) & (age[None, :] <= lpos[:, None])
            vis_stg = torch.arange(j + 1, device=dev)[None, :] >= (j - lpos)[:, None]
            x = SD.embed_token(stacked, cfg, tok[:, None], lpos.clamp_min(0))
            x, inflight = SD.layer_stack_step_inflight(
                stacked, layers, inflight, x, vis_cache, vis_stg, st["src_mask"][:, 0, :],
                cfg.num_heads, cfg.quantize_attn_probs)
            nxt = _i32(torch.argmax(SD.final_logits(stacked, x), dim=-1))
            nxt = torch.where(live, nxt, cfg.pad_id)
            new_live = live & (nxt != cfg.eos_id) & (lpos + 2 < T)
            died = live & ~new_live
            died_at = torch.where(died, j, died_at)
            n_final = torch.where(died, lpos + 1, n_final)
            dead_tag = torch.where(died, st["tag"], dead_tag)
            dead_start = torch.where(died, start, dead_start)
            outs.append(nxt)
            st["occ"] = st["occ"] + _i32(live.sum())
            st["tok"] = torch.where(live, nxt, tok)
            st["live"] = new_live
        # batched landings: completions (from the pre-chunk ring), KV flush,
        # output ring
        snap()
        SD.flush_inflight(layers, inflight, w0)
        out_before[:, w0:w0 + self.chunk] = torch.stack(outs, dim=1)
        st["occ_steps"] = st["occ_steps"] + self.chunk
        st["g"] = (g0 + self.chunk) % self._GWRAP

    def _refill_beam(self, st: dict, head: int) -> None:
        """Group-granular refill: a free group (no live beam) takes one
        staged request; its cross-K/V rows land in all K slots of the group,
        beam 0 starts at score 0 and beams 1..K-1 at -1e9 (the lockstep
        beam init)."""
        K, B, G = self.beam, self.B, self.B // self.beam
        free_g = ~st["live"].view(G, K).any(dim=1)                        # [G]
        rank = _i32(torch.cumsum(free_g, 0)) - 1
        avail = torch.remainder(head - st["tail"], self._HWRAP)
        room = st["cur"] < self._C - 2 * G
        take = free_g & (rank < avail) & (rank < G) & room
        unfilled = free_g & ~take
        st["starve"] = st["starve"] + K * _i32((unfilled & (rank >= avail)).sum())
        st["gated"] = st["gated"] + K * _i32((unfilled & (rank < avail)).sum())
        sidx = torch.remainder(st["tail"] + rank.clamp_min(0), self.R).long()
        # made on the device: a host-to-device copy would wait for the queue
        init_scores = torch.where(torch.arange(B, device=self.device) % K == 0, 0.0, -1e9)
        self._refill_slots(st, take.repeat_interleave(K), sidx.repeat_interleave(K), {
            "tok": self.model.cfg.bos_id, "start": st["g"], "scores": init_scores,
            "fin": False, "blen": 1})
        st["tail"] = torch.remainder(st["tail"] + _i32(take.sum()), self._HWRAP)

    @torch.no_grad()
    def _chunk_beam(self, st: dict, head: int) -> None:
        """Advance the slot pool ``chunk_steps`` beam steps.  Per step: one
        batched ``decode_step`` over all B beam-slots (log-probs: scores
        accumulate), per-group top-K over [K*V] candidates, and a
        beam-ancestry gather of the self-KV ring rows and the output ring.
        A group completes when all K beams have emitted EOS (or hit the ring
        cap); its completion row carries the best beam by the GNMT length
        penalty, the selection of the lockstep ``beam_decode``."""
        cfg = self.model.cfg
        K, B, T, dev = self.beam, self.B, self.T, self.device
        G = B // K
        v = cfg.tgt_vocab_size
        pad_row = torch.full((B, v), -1e9, device=dev)
        pad_row[:, cfg.pad_id] = 0.0
        alpha = self.length_penalty
        self_keys = ("k", "v", "k_scale", "v_scale") if self.kv_dtype == "int8" else ("k", "v")
        group_base = torch.arange(G, device=dev)[:, None] * K
        slots = torch.arange(B, device=dev)
        self._refill_beam(st, head)
        for _ in range(self.chunk):
            g = st["g"]
            live = st["live"]
            glive = live.view(G, K).any(dim=1)                            # [G]
            lpos = torch.where(live, torch.remainder(g - st["start"], self._GWRAP), -1)
            w = g % T
            logp, cache = self.model.decode_step(
                self.params, st["cache"], st["tok"][:, None], lpos, st["src_mask"],
                lin=self.lin, log_probs=True, ring_index=w)
            logp = torch.where(st["fin"][:, None], pad_row, logp)
            cand = (st["scores"][:, None] + logp).reshape(G, K * v)
            top_scores, top_idx = _top_k_stable(cand, K)                  # [G, K]
            flat_src = (group_base + top_idx // v).reshape(-1)
            tok_idx = _i32(top_idx % v).reshape(-1)
            gl_slot = glive.repeat_interleave(K)                          # [B]
            # dead groups keep their state inert
            keep = torch.where(gl_slot, flat_src, slots)
            # the gathers allocate new tensors: nothing reads the pre-gather
            # self cache after this (decode_step writes in place)
            st["cache"] = {"layers": [
                {key: (val[keep] if key in self_keys else val) for key, val in lc.items()}
                for lc in cache["layers"]]}
            nxt = torch.where(gl_slot, tok_idx, cfg.pad_id)
            out = st["out"][keep]
            out[:, w] = nxt
            fin_src = st["fin"][keep]
            blen_src = st["blen"][keep]
            fin = torch.where(gl_slot, fin_src | (nxt == cfg.eos_id), fin_src)
            blen = torch.where(gl_slot & ~fin_src, blen_src + 1, blen_src)
            scores = torch.where(gl_slot, top_scores.reshape(-1), st["scores"])
            # group death: all beams finished, or the ring cap reached
            lpos_g = lpos.view(G, K)[:, 0]
            glive_new = glive & ~fin.view(G, K).all(dim=1) & (lpos_g + 2 < T)
            died = glive & ~glive_new
            norm = (scores / ((5.0 + blen.float()) / 6.0) ** alpha).view(G, K)
            best_flat = torch.arange(G, device=dev) * K + torch.argmax(norm, dim=1)
            entry = torch.cat([st["tag"].view(G, K)[:, :1], (lpos_g + 1)[:, None],
                               torch.remainder(st["start"].view(G, K)[:, :1], T),
                               self._pack_ring(out[best_flat])], dim=1)
            st["cur"] = self._land(st["comp"], st["cur"], died, entry)
            live_new = glive_new.repeat_interleave(K)
            st.update(tok=torch.where(live_new, nxt, st["tok"]), live=live_new, out=out,
                      scores=scores, fin=fin, blen=blen,
                      occ=st["occ"] + _i32(live.sum()), occ_steps=st["occ_steps"] + 1,
                      g=(g + 1) % self._GWRAP)

    def _header(self, st: dict) -> torch.Tensor:
        """[1, HW] int32: cur, tail, occ, occ_steps, starve, gated."""
        vals = torch.stack([st[k] for k in ("cur", "tail", "occ", "occ_steps", "starve",
                                            "gated")])
        return F.pad(vals, (0, self._HW - 6))[None, :]

    def _drain(self, st: dict) -> torch.Tensor:
        """Harvest the completion buffer: the report (row 0 the header; rows
        1..n [tag, n_tokens, ring_start, packed ring...] per finished
        request), a copy taken before the counters reset."""
        comp = st["comp"][: self._C]
        if self._HW > 3 + self._PT:
            comp = F.pad(comp, (0, self._HW - (3 + self._PT)))
        report = torch.cat([self._header(st), comp], dim=0)
        for key in ("cur", "occ", "occ_steps", "starve", "gated"):
            st[key] = torch.zeros_like(st[key])
        return report

    # ------------------------------------------------------------- host side

    def _blank_state(self) -> dict:
        cfg = self.model.cfg
        B, T, S, R, dev = self.B, self.T, self.S, self.R, self.device
        # this rank's heads and columns under a mesh
        h, d = self.model.heads, self.model.width
        dk = cfg.d_model // cfg.num_heads
        dt = cfg.dtype

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def cross(rows):
            if self.kv_dtype == "int8":
                return {"cross_k": zeros((rows, S, d), torch.int8),
                        "cross_v": zeros((rows, S, d), torch.int8),
                        "cross_k_scale": zeros((rows, S, 1)),
                        "cross_v_scale": zeros((rows, S, 1))}
            return {"cross_k": zeros((rows, h, S, dk), dt), "cross_v": zeros((rows, h, S, dk), dt)}

        layers = []
        for _ in range(cfg.num_layers):
            if self.kv_dtype == "int8":
                # merged-head int8 rows; time-major [T, B, *] when the W8A8
                # grid is available
                lead = (T, B) if self._tm else (B, T)
                entry = {"k": zeros((*lead, d), torch.int8), "v": zeros((*lead, d), torch.int8),
                         "k_scale": zeros((*lead, 1)), "v_scale": zeros((*lead, 1))}
            else:
                entry = {"k": zeros((B, h, T, dk), dt), "v": zeros((B, h, T, dk), dt)}
            layers.append(dict(entry, **cross(B)))
        i32 = torch.int32
        return {
            "cache": {"layers": layers},
            "src_mask": zeros((B, 1, S), torch.bool),
            "tag": torch.full((B,), -1, dtype=i32, device=dev),
            "tok": zeros((B,), i32),
            "start": zeros((B,), i32),
            "live": zeros((B,), torch.bool),
            "out": torch.full((B, T), cfg.pad_id, dtype=i32, device=dev),
            "tail": zeros((), i32),
            "g": 0,     # host mirror: advances by exactly one per decode step
            # row C is the spare that surplus and non-dying rows land in
            "comp": zeros((self._C + 1, 3 + self._PT), i32),
            "cur": zeros((), i32),
            # occupancy integral since the last harvest: live slots summed
            # per decode step, and the step count
            "occ": zeros((), i32),
            "occ_steps": zeros((), i32),
            # free slots not refilled, sampled at each refill: ring empty vs
            # budget/backpressure
            "starve": zeros((), i32),
            "gated": zeros((), i32),
            # beam-mode per-slot search state (the greedy paths carry it
            # untouched)
            "scores": zeros((B,)),
            "fin": zeros((B,), torch.bool),
            "blen": torch.ones((B,), dtype=i32, device=dev),
            # staging ring; row R is the spare that padding entries land in
            "stage": {"layers": [cross(R + 1) for _ in range(cfg.num_layers)],
                      "src_mask": zeros((R + 1, 1, S), torch.bool),
                      "tag": torch.full((R + 1,), -1, dtype=i32, device=dev)},
        }

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, copied without waiting for
        the work queued before it (from pinned memory, on a card)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit(self, src_ids: np.ndarray) -> int:
        """Queue one request (padded token ids [S]); returns its id."""
        if len(src_ids) != self.S:
            raise ValueError(f"src must be padded to {self.S}, got {len(src_ids)}")
        src = np.asarray(src_ids, np.int32)
        req = Request(next(self._ids), src)
        n = int(np.sum(src != self.model.cfg.pad_id))
        self._queues[self._bucket_of(max(n, 1))].append(req)
        return req.req_id

    def _admit(self):
        """Dispatch staged prefills for queued requests while ring space is
        (conservatively) known to be free: one batched encoder dispatch per
        group, grouped by source-length bucket (longest queue first)."""
        cfg = self.model.cfg
        while True:
            free_ring = self.R - (self._head - self._tail_known)
            order = sorted(self._queues, key=lambda b: -len(self._queues[b]))
            bucket = next((b for b in order if self._queues[b]), None)
            if bucket is None or free_ring < 1:
                return
            q = self._queues[bucket]
            g = min(self.prefill_chunk, free_ring, len(q))
            group, self._queues[bucket] = q[:g], q[g:]
            k = self.prefill_chunk
            src = np.full((k, bucket), cfg.pad_id, np.int32)
            ring_pos = np.full((k,), self.R, np.int64)
            tags = np.full((k,), -1, np.int32)
            for j, req in enumerate(group):
                src[j] = req.src_ids[:bucket]
                ring_pos[j] = (self._head + j) % self.R
                tags[j] = req.req_id
                self._inflight[req.req_id] = req
            self._head += g
            self._prefill(self._state, self._to_device(src), self._to_device(ring_pos),
                          self._to_device(tags))

    def _complete_harvest(self, rep: np.ndarray, pending_full: list) -> np.ndarray:
        """Pair a fetched (possibly size-estimated) harvest with its retained
        full device report; copy the exact remainder rows when the estimate
        undercounted (rare: one more transfer)."""
        full = pending_full.pop(0)
        n_done = int(rep[0, 0])
        if n_done > rep.shape[0] - 1:
            rep = np.concatenate([rep, full[rep.shape[0]: 1 + n_done].cpu().numpy()], axis=0)
        return rep

    def _drain_report(self, report: np.ndarray) -> list[Request]:
        """Process one fetched report (sync header or full harvest):
        completed rows and the ring-tail/completion-count feedback."""
        tail = int(report[0, 1])
        # the device tail wraps at HWRAP; reports arrive in dispatch order
        # and the in-flight window is < R << HWRAP, so the mod-difference is
        # the exact consumed count since the last report
        self._tail_known += (tail - self._tail_known) % self._HWRAP
        if report.shape[0] == 1:       # sync header: feedback only
            self._cur_known = int(report[0, 0])
            return []
        self._cur_known = 0
        n_done = int(report[0, 0])
        self.occ_live_steps += int(report[0, 2])
        self.occ_slot_steps += int(report[0, 3]) * self.B
        self.starved_slots += int(report[0, 4])
        self.gated_slots += int(report[0, 5])
        finished = []
        cfg = self.model.cfg
        for row in report[1: 1 + n_done]:
            tag, n, smod = int(row[0]), int(row[1]), int(row[2])
            req = self._inflight.pop(tag, None)
            if req is None:      # defensive: duplicate/unknown tag
                continue
            packed = row[3:3 + self._PT].astype(np.int64)
            ring = np.empty(2 * self._PT, np.int32)
            ring[0::2] = packed & 0xFFFF
            ring[1::2] = (packed >> 16) & 0xFFFF
            ring = ring[: self.T]
            toks = []
            for j in range(n):   # unwrap the output ring: logical j+1 sits
                t = int(ring[(smod + j) % self.T])  # at physical start+j
                if t == cfg.eos_id or t == cfg.pad_id:
                    break
                toks.append(t)
            req.out_tokens = toks
            req.done = True
            finished.append(req)
        return finished

    def _pending(self) -> bool:
        return bool(self._inflight) or any(self._queues.values())

    def run(self, pipeline_depth: int = 2, drain_every: int = 4) -> list[Request]:
        """Process the queue to completion; returns the finished requests.

        The host enqueues prefill, chunk and sync/harvest work and processes
        reports that have already landed; it waits on the device only when
        ``pipeline_depth`` reports are in flight, or in the drain tail.
        Feedback and results are split:

        - every ``drain_every`` chunks a SYNC copies one header row back:
          the staging-ring tail for admission and the pending-completion
          count;
        - a HARVEST (the report, and the device counters reset) is taken
          only when the completion estimate says the buffer is worth it, or,
          once the submit queue is empty, when every in-flight request
          should have finished (the drain tail).
        """
        if self._state is None:
            self._state = self._blank_state()
        done: list[Request] = []
        self._admit()
        fetches: collections.deque = collections.deque()
        since_sync = 0
        since_harvest = 0
        empty_harvests = 0
        self._cur_known = 0
        # completion-rate estimate (deaths per chunk), refined from every
        # processed harvest, so harvests are timed without a feedback copy
        est = self.B * self.chunk * 3.0 / max(self.T, 1)
        windows: list[int] = []   # chunks covered by each in-flight harvest
        gen = 0                   # harvest generation (stale-sync guard)
        # the full device reports, kept for the rare remainder copy: the
        # harvest copy is sized to the estimated completion count
        pending_full: list = []

        def enqueue(arr, kind):
            nonlocal since_sync
            fetches.append(_Fetch(arr, kind, gen))
            since_sync = 0

        dbg = os.environ.get("ENGINE_DEBUG")
        td = {"admit": 0.0, "chunk": 0.0, "drain": 0.0, "proc": 0.0,
              "iters": 0, "chunks": 0, "harvests": 0}
        while self._pending():
            td["iters"] += 1
            _t = time.perf_counter() if dbg else 0.0
            # top up the staging ring before every chunk (a no-op when the
            # conservative free-space estimate says the ring is full)
            self._admit()
            if dbg:
                td["admit"] += time.perf_counter() - _t
            queued = sum(len(q) for q in self._queues.values())
            # drain tail: when the rate estimate says every in-flight request
            # has completed, stop dispatching chunks (each burns chunk*B dead
            # slot-steps) and go straight to a harvest
            tail_done = (queued == 0 and bool(self._inflight)
                         and since_harvest * est >= 1.1 * len(self._inflight))
            if not tail_done:
                _t = time.perf_counter() if dbg else 0.0
                self._chunk(self._state, self._head % self._HWRAP)
                if dbg:
                    td["chunk"] += time.perf_counter() - _t
                    td["chunks"] += 1
                since_sync += 1
                since_harvest += 1
            # harvest when the estimated completion count nears the buffer's
            # capacity, or (drain tail) pending requests should have finished
            want = (since_harvest * est >= 0.7 * self._C
                    or self._cur_known >= self._C // 2
                    or since_harvest * self.chunk >= 2 * self.T
                    or tail_done)
            if want:
                _t = time.perf_counter() if dbg else 0.0
                report = self._drain(self._state)
                # size the copy to the expected fill (margin 1.3x+32, bounded
                # by the in-flight count), in 256-row steps; the device report
                # is kept for an exact remainder
                raw = min(int(since_harvest * est * 1.3) + 32, max(len(self._inflight), 1))
                n_est = min(self._C, 256 * (1 + (raw - 1) // 256))
                self._cur_known = 0
                gen += 1       # syncs dispatched earlier are now stale
                windows.append(since_harvest)
                since_harvest = 0
                pending_full.append(report)
                enqueue(report[: 1 + n_est], "harvest")
                if dbg:
                    td["drain"] += time.perf_counter() - _t
                    td["harvests"] += 1
            elif (since_sync >= drain_every
                  and (self.R - (self._head - self._tail_known) < queued
                       or since_harvest * est >= 0.35 * self._C)):
                # sync only when feedback is worth a copy: the staging ring
                # needs the tail to admit the rest of the queue, or a harvest
                # decision is near (confirm with the real cur)
                enqueue(self._header(self._state), "sync")
            # process the reports that have landed; wait when the pipeline is
            # full, or when the drain tail stopped dispatching chunks
            _t = time.perf_counter() if dbg else 0.0
            while fetches:
                # under a mesh every rank must take the same decisions
                block = (len(fetches) >= pipeline_depth or tail_done
                         or self.mesh is not None)
                if not block and not fetches[0].ready():
                    break
                f = fetches.popleft()
                rep = f.result()
                if f.kind == "harvest":
                    rep = self._complete_harvest(rep, pending_full)
                finished = self._drain_report(rep)
                if f.kind == "sync" and f.gen < gen:
                    # this sync predates a harvest that reset the device
                    # counter: its count would trigger an immediate
                    # near-empty harvest (its tail is still valid)
                    self._cur_known = 0
                if rep.shape[0] > 1:   # harvest: refine the rate estimate
                    w = windows.pop(0) if windows else 1
                    est = max(1.0, 0.5 * est + 0.5 * len(finished) / w)
                    empty_harvests = 0 if finished else empty_harvests + 1
                    if empty_harvests > 64:
                        raise EngineStalledError(
                            "engine stalled: 64 consecutive empty harvests with "
                            f"{len(self._inflight)} requests in flight ({len(done)} "
                            "completed results attached)", done)
                done.extend(finished)
                self._admit()
            if dbg:
                td["proc"] += time.perf_counter() - _t
        while fetches:
            f = fetches.popleft()
            rep = f.result()
            if f.kind == "harvest":
                rep = self._complete_harvest(rep, pending_full)
            done.extend(self._drain_report(rep))
        if dbg:
            print(f"ENGINE_DEBUG: {td}", flush=True)
        return done


class BucketedEngineFleet:
    """Per-source-bucket pools of :class:`TranslationEngine`.

    After the self-KV ring, the decode step's largest read is the
    cross-attention K/V, sized by the pool's ``src_len``.  At the IWSLT14
    length distribution (57 % of sources fit in 24 tokens, 90 % in 48) one
    S=72 pool reads cross-K/V that is ~70 % padding; per-bucket pools size
    the cross cache (and staging ring) to the bucket.

    Pools run their queues one after the other (each pool is itself
    continuous-batching); outputs equal a single full-length engine's for
    every request whose source fits its bucket, and sources longer than the
    largest bucket are truncated as the single engine truncates at
    ``src_len``.
    """

    def __init__(self, model, params, lin=default_linear,
                 pools=((24, 512, 72), (48, 512, 72), (72, 512, 72)), **engine_kw):
        # pools: (src_bucket, num_slots, max_len), ascending src_bucket
        self.pools = sorted(pools)
        self.engines = {
            b: TranslationEngine(model, params, lin=lin, num_slots=n, src_len=b,
                                 max_len=t, buckets=(b,), **engine_kw)
            for b, n, t in self.pools
        }
        self._pad = model.cfg.pad_id
        self._ids = itertools.count()
        self._routed: dict[tuple, int] = {}

    def submit(self, src_ids) -> int:
        src = np.asarray(src_ids, np.int32)
        n = int(np.sum(src != self._pad))
        bucket = next((b for b, _, _ in self.pools if n <= b), self.pools[-1][0])
        eng = self.engines[bucket]
        row = np.full((bucket,), self._pad, np.int32)
        take = min(len(src), bucket)
        row[:take] = src[:take]
        rid = eng.submit(row)
        fid = next(self._ids)
        self._routed[(bucket, rid)] = fid
        return fid

    def run(self, pipeline_depth: int = 2, drain_every: int = 5):
        """Drain every pool (largest queue first); returns the finished
        requests with fleet-level ``req_id``."""
        done = []
        order = sorted(self.engines,
                       key=lambda b: -sum(len(q) for q in self.engines[b]._queues.values()))
        for b in order:
            for req in self.engines[b].run(pipeline_depth=pipeline_depth,
                                           drain_every=drain_every):
                req.req_id = self._routed.pop((b, req.req_id), req.req_id)
                done.append(req)
        return done
