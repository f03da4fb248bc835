"""The encoder-decoder model (port of ``onnx_transformer_tpu/models/transformer.py``).

Parameters are a nested structure of dicts and lists of tensors, laid out
as the JAX package's pytree (linear weights stored (in, out)), so a JAX
parameter tree converts leaf by leaf (``params.params_from_jax``).

Every linear goes through the ``lin(name, x, w, b, taps, inject)`` seam
under the reference module name; the W8A8 and W4A8 impls plug in there.
The methods take the reference's ``rng`` (a ``torch.Generator`` whose
draws the dropout sites take in call order), ``train``, ``taps`` and
``inject`` (``ops.layers.tap``) where the reference's do, in its parameter
order.  As in the JAX package, taps and inject route around the kernels:
kernel K3 (``fused_attn``) runs only when neither is given and not
training, the all-int8 attention and the cross-K/V producer
``lin.linear_q8`` only when neither is given.

The KV cache (``init_cache``, ``decode_step``) is a dict of per-layer dicts
of tensors, as in the JAX package, but a step writes its K/V rows into the
cache's buffers in place (the JAX version copies functionally): the cache
that ``decode_step`` returns holds the same buffers it was given.

Tensor parallelism: ``Transformer(cfg, mesh=mesh)`` is this rank's view of
the model over a (data, model) mesh (``parallel.make_mesh``), run on the
rank's parameter slices (``parallel.shard_params``).  Each rank holds
``num_heads / model`` heads and ``d_model / model`` columns of every q/k/v
row, of the attention context and of the K/V caches, whose per-token
scales stay whole (replicated).  Where GSPMD inserts collectives in the
JAX package, the view calls them: the row-parallel out-projection and
``w_2`` sum their partial products over the model group before the bias
is added once (the plain linear here, a mesh-aware impl such as
``make_w8a8_linear_impl(..., mesh=mesh)`` inside itself), and every
per-token scale of a sharded row is the whole row's (a max over the
group).  LayerNorm, the residual stream, the embeddings and the generator
stay replicated, so every rank computes the same logits.

Under autograd the view places Megatron's f/g pair
(``parallel.collectives``): ``f`` (``model_copy``: the identity forward, a
sum over the model group of the gradient backward) where a replicated
activation enters column-parallel linears (the self-attention's q/k/v
input, the cross-attention's q input, the encoder memory that feeds the
cross k/v, the ``w_1`` input), and ``g`` (``model_sum``: the sum forward,
the identity backward) on the row-parallel outputs.  Without autograd
``f`` is no call at all.  Dropout draws its masks in call order: with a
generator seeded alike on every rank of a model group
(``parallel.mesh_generator``), the replicated activations get the same
masks on each rank; for the sharded ones (a rank's heads of the attention
probabilities, its ``d_ff / model`` units of the FFN) each rank draws the
whole tensor's mask and keeps its own block, so the generators stay in step
and the masks of a model group are one device's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch

from onnx_transformer_tpu_torch.device import resolve_device
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.ops.kernels.decode_attention import decode_attention_int8
from onnx_transformer_tpu_torch.parallel.collectives import model_copy, model_sum
from onnx_transformer_tpu_torch.parallel.sharding import check_divisible
from onnx_transformer_tpu_torch.quant.core import quantize_act_per_token

Params = Any
LinearImpl = Callable[..., torch.Tensor]


@dataclass(frozen=True)
class TransformerConfig:
    src_vocab_size: int
    tgt_vocab_size: int
    num_layers: int = 6
    d_model: int = 512
    d_ff: int = 2048
    num_heads: int = 8
    dropout: float = 0.3
    max_len: int = 5000
    quantize_attn_probs: bool = True
    pad_id: int = 2
    bos_id: int = 0
    eos_id: int = 1
    dtype: Any = torch.float32
    # Accepted for the reference's configurations: eager PyTorch has no
    # lax.scan to gain from, so the layers run the same per-layer loop.
    scan_layers: bool = False

    def with_(self, **kw) -> "TransformerConfig":
        return replace(self, **kw)


def default_linear(name: str, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], taps: L.TapDict = None,
                   inject: L.InjectDict = None) -> torch.Tensor:
    """Plain fp linear.  Taps the input under the module name (what
    calibration records) and the output under ``name + ".out"``."""
    x = L.tap(name, x, taps, inject)
    return L.tap(name + ".out", L.linear(x, w, b), taps, inject)


def _scalar_index(idx):
    """A Python int for a scalar write index (int or 0-dim tensor), else
    the [B] tensor unchanged.  A trace cannot read a 0-dim tensor's value:
    a traced step takes [B] positions."""
    if isinstance(idx, torch.Tensor) and idx.ndim == 1:
        return idx
    if isinstance(idx, torch.Tensor) and torch.compiler.is_compiling():
        raise ValueError("a traced decode step takes a [B] tensor of positions, "
                         "not a 0-dim one")
    return int(idx)


def _slice_index(i: int, t: int) -> int:
    """A scalar write position as JAX's dynamic_update_slice takes it:
    negative counts from the end, then clamped into [0, t-1]."""
    if i < 0:
        i += t
    return min(max(i, 0), t - 1)


def _row_scatter(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                 time_axis: int) -> torch.Tensor:
    """buf[b, ..., idx[b], ...] = new[b] along ``time_axis`` (1 or 2), in
    place.  Negative positions count from the end; positions outside
    [-T, T) drop the row's write, as the JAX scatter's ``mode="drop"``: such
    a row writes back what its clamped position holds, so that every shape
    is static (a trace holds no size that depends on the data)."""
    t = buf.shape[time_axis]
    idx = idx.to(buf.device).long()
    idx = torch.where(idx < 0, idx + t, idx)
    keep = ((idx >= 0) & (idx < t)).view(-1, *[1] * (new.ndim - 1))
    at = idx.clamp(0, t - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    if time_axis == 1:
        buf[rows, at] = torch.where(keep, new, buf[rows, at])
    else:
        buf[rows, :, at] = torch.where(keep, new, buf[rows, :, at])
    return buf


def _cache_update(buf: torch.Tensor, new: torch.Tensor, idx) -> torch.Tensor:
    """Write ``new`` [B, H, 1, dk] into ``buf`` [B, H, T, dk] at time
    ``idx``, in place: a scalar (placed as JAX's dynamic_update_slice
    places it, see :func:`_slice_index`) or a [B] vector of per-row
    positions (out-of-range rows dropped).  Returns ``buf``."""
    idx = _scalar_index(idx)
    if isinstance(idx, int):
        buf[:, :, _slice_index(idx, buf.shape[2])] = new[:, :, 0]
        return buf
    return _row_scatter(buf, new[:, :, 0], idx, time_axis=2)


def _scale_update(buf: torch.Tensor, new: torch.Tensor, idx,
                  time_major: bool = False) -> torch.Tensor:
    """Row write for the merged-head int8 caches and their scales, in
    place: ``new`` [B, 1, X] lands at time ``idx`` of ``buf`` [B, T, X], or
    of ``buf`` [T, B, X] with ``time_major`` (scalar ``idx`` only).  Scalar
    indices are placed as :func:`_cache_update` places them, [B] indices
    drop out-of-range rows.  Returns ``buf``."""
    idx = _scalar_index(idx)
    if time_major:
        if not isinstance(idx, int):
            raise ValueError("a time-major cache takes a scalar write index")
        buf[_slice_index(idx, buf.shape[0])] = new[:, 0]
        return buf
    if isinstance(idx, int):
        buf[:, _slice_index(idx, buf.shape[1])] = new[:, 0]
        return buf
    return _row_scatter(buf, new[:, 0], idx, time_axis=1)


class Transformer:
    """Functional encoder-decoder; methods are pure in (params, inputs),
    except that the cached decode writes the KV cache in place.  With a
    ``mesh``, the tensor-parallel view of one rank (module docstring)."""

    def __init__(self, config: TransformerConfig, mesh=None):
        self.cfg = config
        self.mesh = mesh
        m = 1 if mesh is None else mesh.model
        check_divisible(config.num_heads, config.d_ff, m)
        # this rank's heads, and its columns of a merged-head row
        self.heads = config.num_heads // m
        self.width = config.d_model // m

    def _row_linear(self, lin: LinearImpl, name: str, x, p: Params, taps, inject):
        """A row-parallel linear (out-projection, ``w_2``).  Under a mesh the
        rank holds rows of ``w``: a mesh-aware impl sums over the model group
        itself, the plain linear's partial product is summed here and the
        bias added once after the sum."""
        if self.mesh is None or getattr(lin, "mesh", None) is self.mesh:
            return lin(name, x, p["w"], p["b"], taps, inject)
        if lin is not default_linear:
            raise ValueError("under a tensor-parallel mesh a linear impl must be made for it "
                             "(make_w8a8_linear_impl(..., mesh=mesh))")
        return model_sum(lin(name, x, p["w"], None, taps, inject), self.mesh) + p["b"]

    def init(self, seed: int = 0, device=None) -> Params:
        """Random parameters from ``seed``: Xavier-uniform linears and
        embeddings, zero biases, unit LayerNorms, in ``cfg.dtype``.  The
        numbers differ from the JAX package's ``init`` for the same seed."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = cfg.dtype
        gen = torch.Generator(device=dev).manual_seed(seed)

        def lin(d_in, d_out):
            return {"w": L.xavier_uniform(gen, (d_in, d_out), dt),
                    "b": torch.zeros(d_out, dtype=dt, device=dev)}

        def ln():
            return {"scale": torch.ones(cfg.d_model, dtype=dt, device=dev),
                    "bias": torch.zeros(cfg.d_model, dtype=dt, device=dev)}

        def attn():
            return {k: lin(cfg.d_model, cfg.d_model) for k in ("q", "k", "v", "o")}

        def ffn():
            return {"w1": lin(cfg.d_model, cfg.d_ff), "w2": lin(cfg.d_ff, cfg.d_model)}

        enc_layers = [{"self_attn": attn(), "ffn": ffn(), "ln0": ln(), "ln1": ln()}
                      for _ in range(cfg.num_layers)]
        dec_layers = [{"self_attn": attn(), "src_attn": attn(), "ffn": ffn(),
                       "ln0": ln(), "ln1": ln(), "ln2": ln()}
                      for _ in range(cfg.num_layers)]
        return {
            "src_embed": {"lut": L.xavier_uniform(gen, (cfg.src_vocab_size, cfg.d_model), dt)},
            "tgt_embed": {"lut": L.xavier_uniform(gen, (cfg.tgt_vocab_size, cfg.d_model), dt)},
            "encoder": {"layers": enc_layers, "ln": ln()},
            "decoder": {"layers": dec_layers, "ln": ln()},
            "generator": lin(cfg.d_model, cfg.tgt_vocab_size),
        }

    def _shard(self, dim: int) -> Optional[tuple[int, int, int]]:
        """Dropout's ``shard`` for an activation split over ``model`` along
        ``dim`` (None off a mesh)."""
        if self.mesh is None or self.mesh.model == 1:
            return None
        return (dim, self.mesh.model_rank, self.mesh.model)

    def _drop(self, x, rng: Optional[torch.Generator], train: bool,
              shard: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
        return L.dropout(x, self.cfg.dropout, rng, train, shard)

    def embed_src(self, params: Params, src: torch.Tensor, rng=None,
                  train: bool = False) -> torch.Tensor:
        x = L.embed(src, params["src_embed"]["lut"])
        return self._drop(L.positional_encoding(x, 0, self.cfg.max_len), rng, train)

    def embed_tgt(self, params: Params, tgt: torch.Tensor, offset=0, rng=None,
                  train: bool = False) -> torch.Tensor:
        x = L.embed(tgt, params["tgt_embed"]["lut"])
        return self._drop(L.positional_encoding(x, offset, self.cfg.max_len), rng, train)

    def _mha(self, p: Params, name: str, q_in, k_in, v_in, mask, rng, train, taps,
             inject, lin: LinearImpl, self_cache: Optional[dict] = None, cache_index=None,
             kv_precomputed=None, fused_attn: bool = False,
             cache_tm: bool = False) -> torch.Tensor:
        """Multi-headed attention.

        ``self_cache``: the layer's self-attention cache ('k', 'v' fp32
        [B, H, Tmax, dk], or the int8 rows [B, Tmax, D] with 'k_scale' and
        'v_scale' [B, Tmax, 1], or [Tmax, B, *] with ``cache_tm``); this
        step's k/v land at ``cache_index``.  ``kv_precomputed``: the cross
        K/V, a (k, v) pair [B, H, S, dk] or the int8 dict {'kq', 'ks', 'vq',
        'vs'}.  ``fused_attn``: a single-query step over an int8 cache runs
        kernel K3 (``decode_attention_int8``) when no taps or inject are
        given and not training; otherwise the tapped attention runs."""
        cfg = self.cfg
        h = self.heads
        quant = cfg.quantize_attn_probs
        seams = taps is not None or inject is not None
        if self.mesh is not None:
            # f: the replicated stream enters the column-parallel q (and, in
            # self-attention, k and v); the cross k/v's memory took its f in
            # decode
            x = model_copy(q_in, self.mesh)
            k_in, v_in = (x if k_in is q_in else k_in), (x if v_in is q_in else v_in)
            q_in = x
        q_full = lin(f"{name}.linears.0", q_in, p["q"]["w"], p["q"]["b"], taps, inject)
        q = L.split_heads(q_full, h)
        single_step = q.shape[2] == 1 and not train

        def out_proj(ctx):
            return self._row_linear(lin, f"{name}.linears.3", ctx, p["o"], taps, inject)

        def int8_attention(kq, ks, vq, vs):
            """One query step over an int8 cache."""
            if fused_attn and not seams:
                # the merged q and the merged-head cache go to K3 as they are
                ctx = decode_attention_int8(q_full[:, 0, :], kq, ks[..., 0], vq, vs[..., 0],
                                            mask[:, 0, 0, :], num_heads=h, quantize=quant)
                return out_proj(ctx[:, None, :])
            if not seams and getattr(lin, "quantized_output_grid", False):
                # q is on the per-token int8 grid: all-int8-operand attention
                return out_proj(L.int8_cache_attention_qdot(q_full, kq, ks, vq, vs, mask,
                                                            quant, h, self.mesh))
            return out_proj(L.merge_heads(L.int8_cache_attention(
                q, kq, ks, vq, vs, mask, quant, name=name, taps=taps, inject=inject)))

        def dequantized(kq, ks, vq, vs):
            return (L.split_heads(kq.float() * ks, h), L.split_heads(vq.float() * vs, h))

        if kv_precomputed is not None:
            if isinstance(kv_precomputed, dict):   # int8 cross cache
                c = kv_precomputed
                if single_step:
                    return int8_attention(c["kq"], c["ks"], c["vq"], c["vs"])
                k, v = dequantized(c["kq"], c["ks"], c["vq"], c["vs"])
            else:
                k, v = kv_precomputed
        else:
            kfull = lin(f"{name}.linears.1", k_in, p["k"]["w"], p["k"]["b"], taps, inject)
            vfull = lin(f"{name}.linears.2", v_in, p["v"]["w"], p["v"]["b"], taps, inject)
            if self_cache is not None and "k_scale" in self_cache:
                # int8 cache of merged-head rows quantized per token; under
                # W8A8, k and v already sit on that grid, so this is lossless
                kq, ks = quantize_act_per_token(kfull, mesh=self.mesh)
                vq, vs = quantize_act_per_token(vfull, mesh=self.mesh)
                for key, val in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
                    self_cache[key] = _scale_update(self_cache[key], val, cache_index,
                                                    time_major=cache_tm)
                sc = self_cache
                if cache_tm:
                    if not getattr(lin, "quantized_output_grid", False):
                        raise ValueError("a time-major int8 cache needs a W8A8 linear "
                                         "impl whose q sits on the int8 grid")
                    return out_proj(L.int8_cache_attention_qdot_tm(
                        q_full, sc["k"], sc["k_scale"], sc["v"], sc["v_scale"], mask,
                        quant, h, self.mesh))
                if single_step:
                    return int8_attention(sc["k"], sc["k_scale"], sc["v"], sc["v_scale"])
                k, v = dequantized(sc["k"], sc["k_scale"], sc["v"], sc["v_scale"])
            else:
                k = L.split_heads(kfull, h)
                v = L.split_heads(vfull, h)
                if self_cache is not None:
                    k = _cache_update(self_cache["k"], k, cache_index)
                    v = _cache_update(self_cache["v"], v, cache_index)
        ctx = L.scaled_dot_attention(q, k, v, mask, quant, drop_rate=cfg.dropout,
                                     rng=rng, train=train,
                                     name=name, taps=taps, inject=inject,
                                     drop_shard=self._shard(1))
        return out_proj(L.merge_heads(ctx))

    def _ffn(self, p: Params, name: str, x, rng, train, taps, inject,
             lin: LinearImpl) -> torch.Tensor:
        """w_2(dropout(relu(w_1(x))))."""
        if self.mesh is not None:
            x = model_copy(x, self.mesh)   # f: into the column-parallel w_1
        hcur = torch.relu(lin(f"{name}.w_1", x, p["w1"]["w"], p["w1"]["b"], taps, inject))
        hcur = self._drop(hcur, rng, train, self._shard(-1))
        return self._row_linear(lin, f"{name}.w_2", hcur, p["w2"], taps, inject)

    def _sublayer(self, x, ln_p, fn, rng, train) -> torch.Tensor:
        """Pre-norm residual: x + dropout(fn(norm(x)))."""
        return x + self._drop(fn(L.layer_norm(x, ln_p["scale"], ln_p["bias"])), rng, train)

    def _encoder_layer(self, lp, x, mask, rng, train, taps, inject, lin: LinearImpl,
                       nm: str) -> torch.Tensor:
        x = self._sublayer(x, lp["ln0"], lambda h: self._mha(
            lp["self_attn"], f"{nm}.self_attn", h, h, h, mask, rng, train, taps, inject,
            lin), rng, train)
        return self._sublayer(x, lp["ln1"], lambda h: self._ffn(
            lp["ffn"], f"{nm}.feed_forward", h, rng, train, taps, inject, lin), rng, train)

    def _decoder_layer(self, lp, x, memory, tmask, smask, rng, train, taps, inject,
                       lin: LinearImpl, nm: str, layer_cache=None, cache_index=None,
                       kv_cross=None, fused_attn: bool = False,
                       cache_tm: bool = False) -> torch.Tensor:
        x = self._sublayer(x, lp["ln0"], lambda h: self._mha(
            lp["self_attn"], f"{nm}.self_attn", h, h, h, tmask, rng, train, taps, inject,
            lin, self_cache=layer_cache, cache_index=cache_index, fused_attn=fused_attn,
            cache_tm=cache_tm), rng, train)
        x = self._sublayer(x, lp["ln1"], lambda h: self._mha(
            lp["src_attn"], f"{nm}.src_attn", h, memory, memory, smask, rng, train, taps,
            inject, lin, kv_precomputed=kv_cross, fused_attn=fused_attn), rng, train)
        return self._sublayer(x, lp["ln2"], lambda h: self._ffn(
            lp["ffn"], f"{nm}.feed_forward", h, rng, train, taps, inject, lin), rng, train)

    def encode(self, params: Params, src: torch.Tensor, src_mask: torch.Tensor,
               rng: Optional[torch.Generator] = None, train: bool = False,
               taps: L.TapDict = None, inject: L.InjectDict = None,
               lin: LinearImpl = default_linear) -> torch.Tensor:
        """src [B, S] ids, src_mask [B, 1, S] -> memory [B, S, D]."""
        x = self.embed_src(params, src, rng, train)
        mask = src_mask[:, None, :, :] if src_mask is not None else None
        for i, lp in enumerate(params["encoder"]["layers"]):
            x = self._encoder_layer(lp, x, mask, rng, train, taps, inject, lin,
                                    f"encoder.layers.{i}")
        ln_f = params["encoder"]["ln"]
        return L.layer_norm(x, ln_f["scale"], ln_f["bias"])

    def cross_kv(self, params: Params, memory: torch.Tensor,
                 lin: LinearImpl = default_linear, taps: L.TapDict = None,
                 inject: L.InjectDict = None, cache_dtype: str = "fp32") -> list:
        """Cross-attention K/V projections of the encoder memory, per decoder
        layer.  With ``cache_dtype="int8"`` each is int8 rows [B, S, D] plus
        per-token scales [B, S, 1]; without taps and inject, a fused-mode
        W8A8 impl produces those straight from its kernel through
        ``lin.linear_q8``."""
        int8 = cache_dtype == "int8"
        h = self.heads
        q8 = (getattr(lin, "linear_q8", None)
              if int8 and taps is None and inject is None else None)
        layers = []
        for i, lp in enumerate(params["decoder"]["layers"]):
            nm = f"decoder.layers.{i}.src_attn"
            ap = lp["src_attn"]
            if q8 is not None:
                rk = q8(f"{nm}.linears.1", memory)
                rv = q8(f"{nm}.linears.2", memory)
                if rk is not None and rv is not None:
                    layers.append({"cross_k": rk[0], "cross_v": rv[0],
                                   "cross_k_scale": rk[1], "cross_v_scale": rv[1]})
                    continue
            ckf = lin(f"{nm}.linears.1", memory, ap["k"]["w"], ap["k"]["b"], taps, inject)
            cvf = lin(f"{nm}.linears.2", memory, ap["v"]["w"], ap["v"]["b"], taps, inject)
            if int8:
                ckq, cks = quantize_act_per_token(ckf, mesh=self.mesh)
                cvq, cvs = quantize_act_per_token(cvf, mesh=self.mesh)
                layers.append({"cross_k": ckq, "cross_v": cvq,
                               "cross_k_scale": cks, "cross_v_scale": cvs})
            else:
                layers.append({"cross_k": L.split_heads(ckf, h),
                               "cross_v": L.split_heads(cvf, h)})
        return layers

    def decode(self, params: Params, memory, src_mask, tgt_in: torch.Tensor, tgt_mask,
               rng: Optional[torch.Generator] = None, train: bool = False,
               taps: L.TapDict = None, inject: L.InjectDict = None,
               lin: LinearImpl = default_linear, cache: Optional[dict] = None,
               cache_index=None, fused_attn: bool = False, embed_offset=None,
               cache_time_major: bool = False) -> torch.Tensor:
        """Teacher-forced decode, or incremental when ``cache`` is given.

        With a cache, ``tgt_in`` is the current token [B, 1], ``tgt_mask``
        the mask over cache positions [B, 1, Tmax] and ``cache_index`` the
        write position; ``embed_offset`` overrides the positional offset (a
        ring write position is not the logical position).  The cache is
        updated in place.  Returns hidden states [B, T, D]."""
        offset = cache_index if cache is not None else 0
        if embed_offset is not None:
            offset = embed_offset
        x = self.embed_tgt(params, tgt_in, offset, rng, train)
        if self.mesh is not None and memory is not None:
            # f: the memory feeds every layer's column-parallel cross k/v
            memory = model_copy(memory, self.mesh)
        tmask = tgt_mask[:, None, :, :] if tgt_mask is not None else None
        smask = src_mask[:, None, :, :] if src_mask is not None else None
        for i, lp in enumerate(params["decoder"]["layers"]):
            layer_cache, kv_cross = None, None
            if cache is not None:
                layer_cache = cache["layers"][i]
                if "cross_k_scale" in layer_cache:
                    kv_cross = {"kq": layer_cache["cross_k"], "ks": layer_cache["cross_k_scale"],
                                "vq": layer_cache["cross_v"], "vs": layer_cache["cross_v_scale"]}
                elif "cross_k" in layer_cache:
                    kv_cross = (layer_cache["cross_k"], layer_cache["cross_v"])
            x = self._decoder_layer(lp, x, memory, tmask, smask, rng, train, taps, inject,
                                    lin, f"decoder.layers.{i}", layer_cache=layer_cache,
                                    cache_index=cache_index, kv_cross=kv_cross,
                                    fused_attn=fused_attn, cache_tm=cache_time_major)
        ln_f = params["decoder"]["ln"]
        return L.layer_norm(x, ln_f["scale"], ln_f["bias"])

    def generate(self, params: Params, x: torch.Tensor, taps: L.TapDict = None,
                 inject: L.InjectDict = None, lin: LinearImpl = default_linear,
                 log_probs: bool = True) -> torch.Tensor:
        """log_softmax(proj(x)), or the raw logits (argmax-equivalent)."""
        g = params["generator"]
        y = lin("generator.proj", x, g["w"], g["b"], taps, inject)
        return L.log_softmax(y) if log_probs else y

    def forward(self, params: Params, src, tgt_in, src_mask, tgt_mask,
                rng: Optional[torch.Generator] = None, train: bool = False,
                taps: L.TapDict = None, inject: L.InjectDict = None,
                lin: LinearImpl = default_linear) -> torch.Tensor:
        """Hidden states of the teacher-forced decoder, not logits.  The
        encoder's dropout sites draw from ``rng`` first, then the decoder's."""
        memory = self.encode(params, src, src_mask, rng, train, taps, inject, lin)
        return self.decode(params, memory, src_mask, tgt_in, tgt_mask, rng, train, taps,
                           inject, lin)

    def forward_logits(self, params: Params, src, tgt_in, src_mask, tgt_mask,
                       **kw) -> torch.Tensor:
        h = self.forward(params, src, tgt_in, src_mask, tgt_mask, **kw)
        return self.generate(params, h, taps=kw.get("taps"), inject=kw.get("inject"),
                             lin=kw.get("lin", default_linear))

    def init_cache(self, params: Params, memory: torch.Tensor, max_len: int,
                   lin: LinearImpl = default_linear, taps: L.TapDict = None,
                   inject: L.InjectDict = None, cache_dtype: str = "fp32",
                   time_major: bool = False) -> dict:
        """Empty self-attention K/V buffers plus the cross-attention
        projections of the encoder memory, per decoder layer.  ``int8``:
        merged-head int8 rows [B, Tmax, D] (or [Tmax, B, D] with
        ``time_major``) and per-token scales; ``fp32``: [B, H, Tmax, dk].  Under
        a mesh, this rank's D / model columns and H / model heads."""
        cfg = self.cfg
        b, dev = memory.shape[0], memory.device
        h, dk, d = self.heads, cfg.d_model // cfg.num_heads, self.width
        layers = []
        for cross in self.cross_kv(params, memory, lin=lin, taps=taps, inject=inject,
                                   cache_dtype=cache_dtype):
            entry = dict(cross)
            if cache_dtype == "int8":
                lead = (max_len, b) if time_major else (b, max_len)
                entry.update(
                    k=torch.zeros((*lead, d), dtype=torch.int8, device=dev),
                    v=torch.zeros((*lead, d), dtype=torch.int8, device=dev),
                    k_scale=torch.zeros((*lead, 1), device=dev),
                    v_scale=torch.zeros((*lead, 1), device=dev))
            else:
                entry.update(k=torch.zeros((b, h, max_len, dk), dtype=memory.dtype, device=dev),
                             v=torch.zeros((b, h, max_len, dk), dtype=memory.dtype, device=dev))
            layers.append(entry)
        return {"layers": layers}

    def decode_step(self, params: Params, cache: dict, tok: torch.Tensor, index,
                    src_mask, lin: LinearImpl = default_linear, taps: L.TapDict = None,
                    inject: L.InjectDict = None, fused_attn: bool = False,
                    log_probs: bool = True, ring_index=None,
                    time_major: bool = False) -> tuple[torch.Tensor, dict]:
        """One KV-cached decoder step -> (next-token log-probs [B, V], cache).

        ``index``: the logical position of ``tok`` [B, 1], an int for a
        lockstep batch or a [B] tensor of per-row positions.  ``ring_index``
        (an int): every row writes at that physical position, and a position
        written ``a`` steps ago is visible to a row iff ``a <= index[row]``.
        The step's K/V rows are written into the cache's buffers in place."""
        k0 = cache["layers"][0]["k"]
        if time_major:
            max_len = k0.shape[0]
        else:
            max_len = k0.shape[1] if k0.ndim == 3 else k0.shape[2]
        dev = tok.device
        b = tok.shape[0]
        pos = torch.arange(max_len, device=dev)
        idx = _scalar_index(index)
        if isinstance(idx, torch.Tensor):
            idx = idx.to(dev)
        if ring_index is not None:
            ring = _scalar_index(ring_index)
            age = torch.remainder(ring - pos, max_len)
            idx_b = idx[:, None, None] if isinstance(idx, torch.Tensor) else idx
            step_mask = (age[None, None, :] <= idx_b).expand(b, 1, max_len)
            write_index = ring
            embed_offset = idx.clamp_min(0) if isinstance(idx, torch.Tensor) else max(idx, 0)
        elif isinstance(idx, torch.Tensor):
            step_mask = pos[None, None, :] <= idx[:, None, None]
            write_index, embed_offset = idx, None
        else:
            step_mask = (pos <= idx)[None, None, :].expand(b, 1, max_len)
            write_index, embed_offset = idx, None
        cache = {"layers": [dict(lc) for lc in cache["layers"]]}
        hid = self.decode(params, None, src_mask, tok, step_mask, taps=taps, inject=inject,
                          lin=lin, cache=cache, cache_index=write_index,
                          fused_attn=fused_attn, embed_offset=embed_offset,
                          cache_time_major=time_major)
        return self.generate(params, hid[:, -1], taps=taps, inject=inject, lin=lin,
                             log_probs=log_probs), cache
