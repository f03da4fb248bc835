"""Reference-checkpoint interop: the reference's ``state_dict`` <-> the
port's param tree (port of ``onnx_transformer_tpu/utils/torch_compat.py``).

The reference persists models as ``torch.save(model.state_dict())``.  These
converters map its names onto the port's tree of tensors, and back.  Weight
convention: ``torch.nn.Linear`` stores (out, in); the port stores (in, out),
as the JAX package does, so weights are transposed on the way through.

Name map (reference module tree):
  encoder.layers.N.self_attn.linears.{0,1,2,3}.{weight,bias} -> self_attn.{q,k,v,o}
  encoder.layers.N.feed_forward.w_{1,2}.{weight,bias}        -> ffn.w{1,2}
  encoder.layers.N.sublayer.{0,1}.norm.{a_2,b_2}             -> ln{0,1}.{scale,bias}
  encoder.norm.{a_2,b_2}                                     -> encoder.ln
  decoder... (src_attn, sublayer.{0,1,2})                    -> src_attn, ln{0,1,2}
  src_embed.0.lut.weight / tgt_embed.0.lut.weight            -> {src,tgt}_embed.lut
  generator.proj.{weight,bias}                               -> generator.{w,b}
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from onnx_transformer_tpu_torch.device import resolve_device

_ATTN = {"0": "q", "1": "k", "2": "v", "3": "o"}


def from_torch_state_dict(state: Mapping[str, object], num_layers: int = 6,
                          device=None) -> dict:
    """A reference-named state dict (tensors or arrays) -> the port's param
    tree of f32 tensors on ``device`` (the card unless given)."""
    dev = resolve_device(device)

    def arr(key):
        t = state[key]
        t = t.detach() if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
        return t.to(device=dev, dtype=torch.float32)

    def lin(prefix):
        return {"w": arr(prefix + ".weight").T.contiguous(), "b": arr(prefix + ".bias")}

    def ln(prefix):
        return {"scale": arr(prefix + ".a_2"), "bias": arr(prefix + ".b_2")}

    def attn(prefix):
        return {v: lin(f"{prefix}.linears.{k}") for k, v in _ATTN.items()}

    def ffn(prefix):
        return {"w1": lin(prefix + ".w_1"), "w2": lin(prefix + ".w_2")}

    enc_layers = []
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        enc_layers.append({
            "self_attn": attn(p + ".self_attn"),
            "ffn": ffn(p + ".feed_forward"),
            "ln0": ln(p + ".sublayer.0.norm"),
            "ln1": ln(p + ".sublayer.1.norm"),
        })
    dec_layers = []
    for i in range(num_layers):
        p = f"decoder.layers.{i}"
        dec_layers.append({
            "self_attn": attn(p + ".self_attn"),
            "src_attn": attn(p + ".src_attn"),
            "ffn": ffn(p + ".feed_forward"),
            "ln0": ln(p + ".sublayer.0.norm"),
            "ln1": ln(p + ".sublayer.1.norm"),
            "ln2": ln(p + ".sublayer.2.norm"),
        })
    return {
        "src_embed": {"lut": arr("src_embed.0.lut.weight")},
        "tgt_embed": {"lut": arr("tgt_embed.0.lut.weight")},
        "encoder": {"layers": enc_layers, "ln": ln("encoder.norm")},
        "decoder": {"layers": dec_layers, "ln": ln("decoder.norm")},
        "generator": lin("generator.proj"),
    }


def to_torch_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The port's param tree -> a reference-named state dict of contiguous
    CPU tensors, which ``torch.save`` writes and the reference's
    ``make_model`` loads with ``load_state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def put(key, t):
        out[key] = t.detach().cpu().contiguous()

    def put_lin(prefix, leaf):
        put(prefix + ".weight", leaf["w"].T)
        put(prefix + ".bias", leaf["b"])

    def put_ln(prefix, leaf):
        put(prefix + ".a_2", leaf["scale"])
        put(prefix + ".b_2", leaf["bias"])

    def put_attn(prefix, leaf):
        for k, v in _ATTN.items():
            put_lin(f"{prefix}.linears.{k}", leaf[v])

    for stack in ("encoder", "decoder"):
        for i, lp in enumerate(params[stack]["layers"]):
            p = f"{stack}.layers.{i}"
            put_attn(p + ".self_attn", lp["self_attn"])
            if "src_attn" in lp:
                put_attn(p + ".src_attn", lp["src_attn"])
            put_lin(p + ".feed_forward.w_1", lp["ffn"]["w1"])
            put_lin(p + ".feed_forward.w_2", lp["ffn"]["w2"])
            put_ln(p + ".sublayer.0.norm", lp["ln0"])
            put_ln(p + ".sublayer.1.norm", lp["ln1"])
            if "ln2" in lp:
                put_ln(p + ".sublayer.2.norm", lp["ln2"])
        put_ln(f"{stack}.norm", params[stack]["ln"])
    put("src_embed.0.lut.weight", params["src_embed"]["lut"])
    put("tgt_embed.0.lut.weight", params["tgt_embed"]["lut"])
    put_lin("generator.proj", params["generator"])
    return out


def load_reference_checkpoint(path: str, num_layers: int = 6, device=None) -> dict:
    """A reference ``.pt`` state-dict file -> the port's param tree on
    ``device`` (the card unless given); only tensors are unpickled."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return from_torch_state_dict(state, num_layers, device)
