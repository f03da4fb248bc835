"""Fault-injection campaigns (port of ``onnx_transformer_tpu/inject/campaign.py``).

A fault is parameterised, not structural: every quantized linear and every
attention matmul is a target with an integer id, and one experiment is a
fault tree of plain Python scalars (target id, fault model, bit, element,
row, col, seed, enabled, encoder side, decode step).  The linear impl and
the inject dict branch on those scalars on the host: a call that the fault
does not hit runs exactly the clean math, and a hit costs the device no
sync (the RANDOM draws come from a CPU generator).

Fault models (the reference campaign script's list):
  INPUT / WEIGHT            single int8/int4 bit flip before the dequantize
  INPUT16 / WEIGHT16        16-wide systolic row / column fault
  RANDOM                    random fp32 value at a random output index
  RANDOM_BITFLIP            fp32 bit flip at an output index

Where the JAX package compiles one decode program and vmaps it over a group
of experiments, the port runs a Python loop over the experiments
(``faulty_greedy_decode_batch``); its results equal the serial calls.

Over a mesh (``run_campaign(..., mesh=mesh)``) the sources split over
``data`` and the model stays replicated, as in the JAX package's dry run.
A fault's flat element, token row and RANDOM index address the whole
batch, as they do on JAX's global arrays: the fault tree carries the rank's
part of the batch (``part`` of ``parts``), and only the rank that holds the
addressed element changes it.  The tokens are gathered back in order, so
the rows, BLEUs and CSV are one device's.
"""

from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from onnx_transformer_tpu_torch.evaluation.bleu import sentence_bleu
from onnx_transformer_tpu_torch.inject import bits as B
from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.ops.kernels.w8a8_matmul import int_mm
from onnx_transformer_tpu_torch.parallel.mesh import gather_rows, local_rows
from onnx_transformer_tpu_torch.quant import core as Q
from onnx_transformer_tpu_torch.quant.w8a8 import is_quantized_output, quantized_linear_names
from onnx_transformer_tpu_torch.serving.decode import _on_device, ids_to_tokens

FAULT_MODELS = ("INPUT", "WEIGHT", "INPUT16", "WEIGHT16", "RANDOM", "RANDOM_BITFLIP")
_FM = {name: i for i, name in enumerate(FAULT_MODELS)}


def attention_matmul_names(num_layers: int) -> list[str]:
    """Injectable attention matmul targets: the reference's First/SecondMatMul
    descriptors (QK^T and probs x V), the decoder's for self and cross
    attention."""
    out = []
    for i in range(num_layers):
        out += [f"encoder.layers.{i}.self_attn.qk_matmul",
                f"encoder.layers.{i}.self_attn.av_matmul"]
    for i in range(num_layers):
        for att in ("self_attn", "src_attn"):
            out += [f"decoder.layers.{i}.{att}.qk_matmul",
                    f"decoder.layers.{i}.{att}.av_matmul"]
    return out


def _ids_from_keys(payload_keys, num_layers: int) -> dict[str, int]:
    names = sorted(payload_keys) + sorted(attention_matmul_names(num_layers))
    return {name: i for i, name in enumerate(names)}


def target_ids(model: Transformer) -> dict[str, int]:
    """Stable name -> integer id for every injectable target: the 96
    quantized linears plus the 36 attention matmuls at N=6."""
    return _ids_from_keys(quantized_linear_names(model.cfg.num_layers),
                          model.cfg.num_layers)


@dataclass
class FaultSpec:
    """One experiment (one row of the reference's descriptor sweep)."""

    target: str
    fault_model: str = "INPUT"
    bit: int = 0
    element: int = 0        # flat index for single-element faults
    row: int = 0            # INPUT16: token row; WEIGHT16: row_start
    col: int = 0            # INPUT16: col_start; WEIGHT16: column
    seed: int = 0
    inject_step: int = 0    # decode step at which a decoder fault is live
    ref_name: str = ""      # the reference's MatMul node name, when the spec
                            # was read from its descriptors (reference CSV)

    def scalars(self, ids: dict[str, int]) -> dict:
        return {"target": ids[self.target], "model": _FM[self.fault_model],
                "bit": self.bit, "element": self.element, "row": self.row,
                "col": self.col, "seed": self.seed}


def _fault_tree(spec: Optional[FaultSpec], ids: dict[str, int], part: int = 0,
                parts: int = 1) -> dict:
    """The fault as host scalars; ``None`` is the disabled (golden) fault.
    ``part`` of ``parts``: the data rank's part of the batch (module
    docstring)."""
    if spec is None:
        return {"target": 0, "model": 0, "bit": 0, "element": 0, "row": 0, "col": 0,
                "seed": 0, "enabled": False, "is_encoder": False, "step": 0,
                "part": part, "parts": parts}
    return {**spec.scalars(ids), "enabled": True,
            "is_encoder": spec.target.startswith("encoder"), "step": spec.inject_step,
            "part": part, "parts": parts}


def _frame(fault: dict) -> tuple[int, int]:
    """(part, parts) of a fault tree (a whole batch without them)."""
    return fault.get("part", 0), fault.get("parts", 1)


def _flip(kind: str, bit: int):
    return lambda v: B.FLIPS[kind](v, bit)


def _apply_elem(x: torch.Tensor, elem: int, fn, frame: tuple[int, int] = (0, 1)
                ) -> torch.Tensor:
    """``fn`` applied to one flat element (the index clipped into range).
    ``frame`` = (part, parts): ``x`` is part ``part`` of ``parts`` equal
    batch-major parts of a whole tensor, ``elem`` indexes the whole, and
    ``x`` changes only where it holds that element."""
    part, parts = frame
    n = x.numel()
    i = min(max(elem, 0), n * parts - 1) - part * n
    if not 0 <= i < n:
        return x
    flat = x.reshape(-1).clone()
    flat[i:i + 1] = fn(flat[i:i + 1])
    return flat.reshape(x.shape)


def _flip_rows(q: torch.Tensor, fault: dict, kind: str, width: int) -> torch.Tensor:
    """INPUT16 on the flattened token rows: ``width`` features of one row
    (of the whole batch's rows, see :func:`_apply_elem`)."""
    rows = q.reshape(-1, q.shape[-1])
    row = fault["row"] - _frame(fault)[0] * rows.shape[0]
    return B.flip_row_segment(rows, row, fault["col"], width, fault["bit"],
                              kind).reshape(q.shape)


def _output_fault(y: torch.Tensor, fault: dict, fm: str) -> torch.Tensor:
    """RANDOM: a random fp32 value at a random index (from a CPU generator
    seeded with the spec's seed); RANDOM_BITFLIP: an fp32 bit flip at the
    spec's element."""
    if fm == "RANDOM":
        return B.set_random_value(y, torch.Generator().manual_seed(fault["seed"]),
                                  _frame(fault))
    return _apply_elem(y, fault["element"], _flip("float32", fault["bit"]), _frame(fault))


def make_fault_linear_impl(payloads: dict, ids: dict[str, int], fault: dict, active: bool,
                           bits: int = 8, width: int = 16):
    """W8A8 linear impl (the ``int8`` chain) with the fault seam.  ``fault``
    is a fault tree (:func:`_fault_tree`); with ``active`` False, or on a
    call the fault does not target, it runs the clean chain.

    WEIGHT faults are int32 corrections after the product: a flipped weight
    (r, c) adds ``xq[:, r] * (flip(w[r, c]) - w[r, c])`` to output column c,
    so the weight payload is never copied.  WEIGHT16 takes ``width`` rows
    from ``row`` down one column; its slice start is clamped into range but
    rows above the requested start are masked, so a segment that overruns K
    is truncated."""
    kind = "int8" if bits == 8 else "int4"

    def lin(name: str, x, w, b, taps: L.TapDict = None, inject: L.InjectDict = None):
        p = payloads.get(name)
        if p is None:
            return default_linear(name, x, w, b, taps, inject)
        fm = (FAULT_MODELS[fault["model"]]
              if active and fault["target"] == ids[name] else None)
        flip = _flip(kind, fault["bit"])
        x = L.tap(name, x, taps, inject)
        sx = Q.act_scale_per_token(x, bits)
        xq = Q.quantize(x, sx, bits)
        if fm == "INPUT":
            xq = _apply_elem(xq, fault["element"], flip, _frame(fault))
        elif fm == "INPUT16":
            xq = _flip_rows(xq, fault, kind, width)
        wq = p["wq"]
        kdim, n = wq.shape
        xq2 = xq.reshape(-1, kdim)
        y32 = int_mm(xq2, wq)
        if fm == "WEIGHT":
            r1 = min(max(fault["element"] // n, 0), kdim - 1)
            c1 = min(max(fault["element"] % n, 0), n - 1)
            w1 = wq[r1:r1 + 1, c1:c1 + 1]
            d1 = flip(w1).to(torch.int32) - w1.to(torch.int32)
            y32[:, c1:c1 + 1] += xq2[:, r1:r1 + 1].to(torch.int32) * d1
        elif fm == "WEIGHT16":
            seg = min(width, kdim)
            r0 = min(max(fault["row"], 0), kdim - seg)
            lo, hi = max(r0, fault["row"]), r0 + seg
            c2 = min(max(fault["col"], 0), n - 1)
            if lo < hi:
                wseg = wq[lo:hi, c2:c2 + 1]
                dseg = flip(wseg).to(torch.int32) - wseg.to(torch.int32)     # [rows, 1]
                xseg = xq2[:, lo:hi].to(torch.int32)
                y32[:, c2:c2 + 1] += (xseg * dseg[:, 0]).sum(dim=1, keepdim=True,
                                                              dtype=torch.int32)
        y = y32.float() * (sx.reshape(-1, 1) * p["sw"][None, :])
        y = (y + p["b"]).reshape(*xq.shape[:-1], -1)
        if fm in ("RANDOM", "RANDOM_BITFLIP"):
            y = _output_fault(y, fault, fm)
        y = L.tap(f"{name}.out", y, taps, inject)
        if is_quantized_output(name):
            y = Q.fake_quant_act_per_token(y, bits)
            # the attention matmuls' operand seam: q/k/v on their int8 grid
            y = L.tap(f"{name}.out_q", y, taps, inject)
        return y

    return lin


def _flip_int_grid(x: torch.Tensor, fault: dict, kind: str, scale=None, bits: int = 8,
                   wide: bool = False, width: int = 16) -> torch.Tensor:
    """Bit flip of a fake-quantized fp tensor in its integer domain: recover
    the ints on the grid (``scale=None`` recomputes the per-token absmax
    scale, exact for absmax-quantized tensors), flip, dequantize."""
    s = Q.act_scale_per_token(x, bits) if scale is None else scale
    q = torch.round(x / s).to(torch.int8)
    if wide:
        q = _flip_rows(q, fault, kind, width)
    else:
        q = _apply_elem(q, fault["element"], _flip(kind, fault["bit"]), _frame(fault))
    return q.float() * s


def make_fault_inject(num_layers: int, ids: dict[str, int], fault: dict, active: bool,
                      bits: int = 8) -> dict:
    """Inject dict for a fault on an attention matmul target: the one tap
    site its fault model hits (none for a linear target, which the linear
    impl carries; ``num_layers`` is the reference's signature).

      qk_matmul: INPUT(16) -> q int8 (the q projection's quantized output),
                 WEIGHT(16) -> k int8, RANDOM* -> the fp32 scores.
      av_matmul: INPUT(16) -> probs on the 1/127 grid, WEIGHT(16) -> v int8,
                 RANDOM* -> the fp32 context.

    The dict is never ``None``, so the model takes the tapped attention for
    every call, as in the JAX package."""
    if not active:
        return {}
    kind = "int8" if bits == 8 else "int4"
    fm = FAULT_MODELS[fault["model"]]
    nm, _, op = next(t for t, i in ids.items() if i == fault["target"]).rpartition(".")
    if op == "qk_matmul":
        sites, out = {"INPUT": "linears.0.out_q", "WEIGHT": "linears.1.out_q"}, "scores"
    elif op == "av_matmul":
        sites, out = {"INPUT": "probs", "WEIGHT": "linears.2.out_q"}, "context"
    else:
        return {}
    site = sites.get(fm.removesuffix("16"), out)
    if site == out:
        return {f"{nm}.{site}": lambda x: _output_fault(x, fault, fm)}

    def fn(x):
        # the probabilities sit on the 1/127 grid, not on a per-token one
        scale = torch.full((), 1.0 / 127.0, device=x.device) if site == "probs" else None
        return _flip_int_grid(x, fault, kind, scale, bits, wide=fm.endswith("16"))

    return {f"{nm}.{site}": fn}


@torch.no_grad()
def faulty_greedy_decode(model: Transformer, payload_keys: tuple, params, payloads,
                         fault: dict, max_len: int, src, src_mask,
                         bits: int = 8) -> torch.Tensor:
    """Greedy decode with the fault -> int32 ids [B, max_len].  An encoder
    fault fires during encode, a decoder fault at decode step
    ``fault["step"]`` only; ``fault["enabled"]`` False is the golden run.
    The self-attention cache is int8 (lossless under W8A8)."""
    cfg = model.cfg
    n = cfg.num_layers
    ids = _ids_from_keys(payload_keys, n)
    enc_active = fault["enabled"] and fault["is_encoder"]
    memory = model.encode(params, src, src_mask,
                          inject=make_fault_inject(n, ids, fault, enc_active, bits),
                          lin=make_fault_linear_impl(payloads, ids, fault, enc_active, bits))
    cache = model.init_cache(params, memory, max_len, lin=make_fault_linear_impl(
        payloads, ids, fault, False, bits), cache_dtype="int8")
    b = src.shape[0]
    ys = torch.full((b, max_len), cfg.pad_id, dtype=torch.int32, device=src.device)
    ys[:, 0] = cfg.bos_id
    finished = torch.zeros(b, dtype=torch.bool, device=src.device)
    last = ys[:, 0]
    for i in range(max_len - 1):
        dec_active = fault["enabled"] and not fault["is_encoder"] and i == fault["step"]
        logp, cache = model.decode_step(
            params, cache, last[:, None], i, src_mask,
            lin=make_fault_linear_impl(payloads, ids, fault, dec_active, bits),
            inject=make_fault_inject(n, ids, fault, dec_active, bits))
        nxt = torch.argmax(logp, dim=-1).to(torch.int32)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_id), nxt)
        finished = finished | (nxt == cfg.eos_id)
        ys[:, i + 1] = nxt
        last = nxt
    return ys


def faulty_greedy_decode_batch(model: Transformer, payload_keys: tuple, params, payloads,
                               faults: Sequence[dict], max_len: int, src, src_mask,
                               bits: int = 8) -> torch.Tensor:
    """A group of experiments -> ids [E, B, max_len], one decode after the
    other (each equal to its serial call)."""
    return torch.stack([faulty_greedy_decode(model, payload_keys, params, payloads, f,
                                             max_len, src, src_mask, bits) for f in faults])


def reference_matmul_to_target(module: str, target_layer: str) -> str:
    """Map a reference descriptor (``{"module", "target_layer"}``) to a
    target name.  The reference numbers its MatMul nodes in topological
    order: encoder layer i owns 3+8i (QK^T), 4+8i (probs x V), 6+8i (FFN
    w1), 7+8i (FFN w2); decoder layer i owns 15+12i/16+12i (self-attention
    pair), 19+12i/20+12i (cross-attention pair), 22+12i/23+12i (FFN)."""
    n = int(target_layer.rsplit("_", 1)[1])
    kind_by_tag = {"FirstFC": "feed_forward.w_1", "SecondFC": "feed_forward.w_2",
                   "FirstMatMul": "qk_matmul", "SecondMatMul": "av_matmul"}
    side, tag = module.split("/")
    kind = kind_by_tag[tag]
    if side == "Encoder":
        i = (n - 3) // 8
        if "matmul" in kind:
            kind = f"self_attn.{kind}"
        return f"encoder.layers.{i}.{kind}"
    i, o = divmod(n - 15, 12)
    if "matmul" in kind:
        attn = "self_attn" if o in (0, 1) else "src_attn"
        kind = f"{attn}.{kind}"
    return f"decoder.layers.{i}.{kind}"


def specs_from_reference_jsons(path, fault_models: Sequence[str] = FAULT_MODELS,
                               bit_positions: Sequence[int] = range(8), inject_step: int = 0,
                               seed: int = 0) -> list[FaultSpec]:
    """Read reference campaign descriptors (a JSON file, a directory of
    them, or a list of paths) and expand each target over ``fault_models``
    x ``bit_positions``, as the reference campaign script does."""
    def expand(p):
        p = str(p)
        if os.path.isdir(p):
            return sorted(os.path.join(p, f) for f in os.listdir(p) if f.endswith(".json"))
        return [p]

    entries = list(path) if isinstance(path, (list, tuple)) else [path]
    files = [f for e in entries for f in expand(e)]
    specs = []
    for i, fp in enumerate(files):
        with open(fp) as f:
            d = json.load(f)
        target = reference_matmul_to_target(d["module"], d["target_layer"])
        for fm in fault_models:
            for bit in bit_positions:
                specs.append(FaultSpec(target=target, fault_model=fm, bit=bit, seed=seed + i,
                                       inject_step=inject_step, ref_name=d["target_layer"]))
    return specs


@dataclass
class CampaignResult:
    rows: list = field(default_factory=list)     # dicts: layer, golden/faulty bleu, ...
    golden: Optional[np.ndarray] = None          # the golden ids [B, max_len]
    faulty: list = field(default_factory=list)   # each spec's ids [B, max_len]
    golden_seconds: float = 0.0                  # the golden decode, host clock
    groups: list = field(default_factory=list)   # (experiments, seconds) per group


CSV_FORMATS = ("full", "reference")


def write_csv(rows: Sequence[dict], path: str, csv_format: str = "full") -> None:
    """``full``: ``layer,golden_bleu,faulty_bleu,bit,fault_model`` with a
    header row; ``reference``: the reference's headerless
    ``node_name,golden_bleu,faulty_bleu`` rows (the descriptor's MatMul
    name where the spec came from one, else the target name)."""
    if csv_format not in CSV_FORMATS:
        raise ValueError(f"csv_format {csv_format!r} is not one of {CSV_FORMATS}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        if csv_format == "full":
            writer.writerow(["layer", "golden_bleu", "faulty_bleu", "bit", "fault_model"])
        for row in rows:
            if csv_format == "reference":
                writer.writerow([row["ref_name"] or row["layer"], row["golden_bleu"],
                                 row["faulty_bleu"]])
            else:
                writer.writerow([row["layer"], row["golden_bleu"], row["faulty_bleu"],
                                 row["bit"], row["fault_model"]])


def run_campaign(model: Transformer, params, payloads: dict, specs: Sequence[FaultSpec],
                 src, src_mask, references: Sequence[Sequence[str]], vocab_tgt,
                 max_len: int = 72, bits: int = 8, csv_path: Optional[str] = None,
                 log_fn=None, fanout: int = 16, csv_format: str = "full",
                 mesh=None) -> CampaignResult:
    """The golden decode once, then the faulty decodes in groups of
    ``fanout``; a sentence BLEU (method4 smoothing) per experiment and
    sentence against ``references``.  Rows whose tokens equal the golden
    ones take the golden BLEU without scoring again.  ``src`` that is not a
    tensor goes to the card.  The rows are written to ``csv_path`` in
    ``csv_format`` (:func:`write_csv`).

    With a ``mesh`` the whole ``src`` and ``src_mask`` are given on every
    rank; each data rank decodes its rows (``local_rows``) with the model
    replicated, the tokens are gathered in order (``gather_rows``), and the
    result is one device's on every rank; rank 0 alone writes the CSV."""
    if csv_path and csv_format not in CSV_FORMATS:
        raise ValueError(f"csv_format {csv_format!r} is not one of {CSV_FORMATS}")
    ids = _ids_from_keys(sorted(payloads), model.cfg.num_layers)
    keys = tuple(sorted(payloads))
    src, src_mask = _on_device(model, src, src_mask)
    src, src_mask = local_rows(src, mesh), local_rows(src_mask, mesh)
    frame = (0, 1) if mesh is None else (mesh.data_rank, mesh.data)

    def decoded(ids_: torch.Tensor, dim: int) -> np.ndarray:
        """Every data rank's rows of ``ids_`` (batch along ``dim``)."""
        whole = gather_rows(ids_.movedim(dim, 0).contiguous(), mesh).movedim(0, dim)
        return whole.cpu().numpy()

    result = CampaignResult()
    t0 = time.perf_counter()
    golden = decoded(faulty_greedy_decode(model, keys, params, payloads,
                                          _fault_tree(None, ids, *frame), max_len, src,
                                          src_mask, bits), 0)
    result.golden, result.golden_seconds = golden, time.perf_counter() - t0
    golden_bleus = [sentence_bleu([list(r)], h, smoothing="method4")
                    for r, h in zip(references, ids_to_tokens(golden, vocab_tgt))]

    specs = list(specs)
    for start in range(0, len(specs), fanout):
        group = specs[start:start + fanout]
        t0 = time.perf_counter()
        outs = decoded(faulty_greedy_decode_batch(model, keys, params, payloads,
                                                  [_fault_tree(s, ids, *frame) for s in group],
                                                  max_len, src, src_mask, bits), 1)
        result.groups.append((len(group), time.perf_counter() - t0))
        result.faulty.extend(outs)
        for spec, faulty in zip(group, outs):
            faulty_toks = ids_to_tokens(faulty, vocab_tgt)
            for gi, (r, h) in enumerate(zip(references, faulty_toks)):
                if np.array_equal(faulty[gi], golden[gi]):
                    fb = golden_bleus[gi]
                else:
                    fb = sentence_bleu([list(r)], h, smoothing="method4")
                result.rows.append({
                    "layer": spec.target, "golden_bleu": golden_bleus[gi],
                    "faulty_bleu": fb, "bit": spec.bit, "fault_model": spec.fault_model,
                    "tokens_changed": B.count_mismatches(golden[gi], faulty[gi]),
                    "ref_name": spec.ref_name})
        if log_fn:
            done = start + len(group)
            n_steady = sum(e for e, _ in result.groups[1:])
            dt = sum(s for _, s in result.groups[1:])
            rate = n_steady / dt if dt > 0 else 0.0
            log_fn(f"{len(result.rows)} rows / {done} specs done (steady {rate:.1f} exp/s)")
    if csv_path and (mesh is None or dist.get_rank() == 0):
        write_csv(result.rows, csv_path, csv_format)
    return result
