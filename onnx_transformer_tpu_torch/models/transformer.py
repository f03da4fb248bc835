"""The encoder-decoder model (port of the encode/cross-KV half of
``onnx_transformer_tpu/models/transformer.py``).

Parameters are a nested structure of dicts and lists of tensors, laid out
as the JAX package's pytree (linear weights stored (in, out)), so a JAX
parameter tree converts leaf by leaf (``params.params_from_jax``).

Every linear goes through the ``lin(name, x, w, b)`` seam under the
reference module name; the W8A8 impl of ``quant/w8a8.py`` plugs in there.
Inference only: no dropout, no taps, no fault injection.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from onnx_transformer_tpu_torch.device import resolve_device
from onnx_transformer_tpu_torch.ops import layers as L
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
    max_len: int = 5000
    quantize_attn_probs: bool = True
    pad_id: int = 2
    bos_id: int = 0
    eos_id: int = 1


def default_linear(name: str, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain fp linear."""
    return L.linear(x, w, b)


class Transformer:
    """Functional encoder-decoder; methods are pure in (params, inputs)."""

    def __init__(self, config: TransformerConfig):
        self.cfg = config

    def init(self, seed: int = 0, device=None) -> Params:
        """Random parameters from ``seed``: Xavier-uniform linears and
        embeddings, zero biases, unit LayerNorms.  The numbers differ from
        the JAX package's ``init`` for the same seed."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def xavier(d_in, d_out):
            a = math.sqrt(6.0 / (d_in + d_out))
            u = torch.rand((d_in, d_out), generator=gen, device=dev)
            return u * (2 * a) - a

        def lin(d_in, d_out):
            return {"w": xavier(d_in, d_out),
                    "b": torch.zeros(d_out, device=dev)}

        def ln():
            return {"scale": torch.ones(cfg.d_model, device=dev),
                    "bias": torch.zeros(cfg.d_model, device=dev)}

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
            "src_embed": {"lut": xavier(cfg.src_vocab_size, cfg.d_model)},
            "tgt_embed": {"lut": xavier(cfg.tgt_vocab_size, cfg.d_model)},
            "encoder": {"layers": enc_layers, "ln": ln()},
            "decoder": {"layers": dec_layers, "ln": ln()},
            "generator": lin(cfg.d_model, cfg.tgt_vocab_size),
        }

    def embed_src(self, params: Params, src: torch.Tensor) -> torch.Tensor:
        x = L.embed(src, params["src_embed"]["lut"])
        return L.positional_encoding(x, 0, self.cfg.max_len)

    def _mha(self, p: Params, name: str, q_in, k_in, v_in, mask,
             lin: LinearImpl) -> torch.Tensor:
        """Multi-headed attention without a cache."""
        h = self.cfg.num_heads
        q = L.split_heads(lin(f"{name}.linears.0", q_in, p["q"]["w"], p["q"]["b"]), h)
        k = L.split_heads(lin(f"{name}.linears.1", k_in, p["k"]["w"], p["k"]["b"]), h)
        v = L.split_heads(lin(f"{name}.linears.2", v_in, p["v"]["w"], p["v"]["b"]), h)
        ctx = L.scaled_dot_attention(q, k, v, mask, self.cfg.quantize_attn_probs)
        return lin(f"{name}.linears.3", L.merge_heads(ctx), p["o"]["w"], p["o"]["b"])

    def _ffn(self, p: Params, name: str, x, lin: LinearImpl) -> torch.Tensor:
        """w_2(relu(w_1(x)))."""
        hcur = torch.relu(lin(f"{name}.w_1", x, p["w1"]["w"], p["w1"]["b"]))
        return lin(f"{name}.w_2", hcur, p["w2"]["w"], p["w2"]["b"])

    @staticmethod
    def _sublayer(x, ln_p, fn) -> torch.Tensor:
        """Pre-norm residual: x + fn(norm(x))."""
        return x + fn(L.layer_norm(x, ln_p["scale"], ln_p["bias"]))

    def _encoder_layer(self, lp, x, mask, lin: LinearImpl, nm: str) -> torch.Tensor:
        x = self._sublayer(x, lp["ln0"], lambda h: self._mha(
            lp["self_attn"], f"{nm}.self_attn", h, h, h, mask, lin))
        return self._sublayer(x, lp["ln1"], lambda h: self._ffn(
            lp["ffn"], f"{nm}.feed_forward", h, lin))

    def encode(self, params: Params, src: torch.Tensor, src_mask: torch.Tensor,
               lin: LinearImpl = default_linear) -> torch.Tensor:
        """src [B, S] ids, src_mask [B, 1, S] -> memory [B, S, D]."""
        x = self.embed_src(params, src)
        mask = src_mask[:, None, :, :] if src_mask is not None else None
        for i, lp in enumerate(params["encoder"]["layers"]):
            x = self._encoder_layer(lp, x, mask, lin, f"encoder.layers.{i}")
        ln_f = params["encoder"]["ln"]
        return L.layer_norm(x, ln_f["scale"], ln_f["bias"])

    def cross_kv(self, params: Params, memory: torch.Tensor,
                 lin: LinearImpl = default_linear,
                 cache_dtype: str = "fp32") -> list:
        """Cross-attention K/V projections of the encoder memory, per decoder
        layer.  With ``cache_dtype="int8"`` each is int8 rows [B, S, D] plus
        per-token scales [B, S, 1]; a fused-mode W8A8 impl produces those
        straight from its kernel through ``lin.linear_q8``."""
        int8 = cache_dtype == "int8"
        h = self.cfg.num_heads
        q8 = getattr(lin, "linear_q8", None) if int8 else None
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
            ckf = lin(f"{nm}.linears.1", memory, ap["k"]["w"], ap["k"]["b"])
            cvf = lin(f"{nm}.linears.2", memory, ap["v"]["w"], ap["v"]["b"])
            if int8:
                ckq, cks = quantize_act_per_token(ckf)
                cvq, cvs = quantize_act_per_token(cvf)
                layers.append({"cross_k": ckq, "cross_v": cvq,
                               "cross_k_scale": cks, "cross_v_scale": cvs})
            else:
                layers.append({"cross_k": L.split_heads(ckf, h),
                               "cross_v": L.split_heads(cvf, h)})
        return layers
