"""The port's fault injection (``inject/bits.py``, ``inject/campaign.py``)
against the JAX package, at the ``qmodel`` configuration of
``tests/test_inject.py`` (vocabularies 37/31, 2 layers, d_model 32, d_ff 64,
4 heads, weights from ``jax.random.key(21)``, sources from
``default_rng(3)`` of shape (4, 8), max_len 10): bit flips bit-equal, the
campaign's tokens identical to JAX's jitted ``faulty_greedy_decode`` (one
compile per configuration, reused for every spec), the faulted step's taps
within atol 1e-4 / rtol 1e-5 of JAX's eager ones.  RANDOM faults draw from
a ``torch.Generator`` where JAX draws from ``jax.random``, so they are held
to their properties instead: one element changes, the seed reproduces it,
NaN clamps to 0."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.evaluation import bleu as JBLEU
from onnx_transformer_tpu.inject import bits as JB
from onnx_transformer_tpu.inject import campaign as JC
from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu.serving.decode import ids_to_tokens as jax_ids_to_tokens
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.inject import bits as TB
from onnx_transformer_tpu_torch.inject import campaign as TC
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving.decode import greedy_decode

TOL = dict(atol=1e-4, rtol=1e-5)
MAX_LEN = 10
UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}

# (target, fault model, fields): the fixed list of the campaign parity test
SPECS = [
    ("encoder.layers.0.self_attn.linears.0", "WEIGHT", dict(bit=7, element=5)),
    ("decoder.layers.1.feed_forward.w_1", "INPUT16", dict(bit=6, row=1, inject_step=2)),
    ("encoder.layers.1.feed_forward.w_2", "INPUT", dict(bit=7, element=11)),
    # row 28 + 16 overruns K = 32: the segment is truncated
    ("decoder.layers.0.src_attn.linears.2", "WEIGHT16",
     dict(bit=6, row=28, col=3, inject_step=1)),
    ("encoder.layers.1.self_attn.qk_matmul", "RANDOM_BITFLIP", dict(bit=30, element=7)),
    ("decoder.layers.1.src_attn.av_matmul", "INPUT", dict(bit=6, element=3, inject_step=3)),
    ("decoder.layers.0.self_attn.qk_matmul", "WEIGHT16", dict(bit=7, col=2, inject_step=2)),
]
BITS4_SPEC = ("encoder.layers.0.feed_forward.w_1", "INPUT", dict(bit=3, element=9))


def _spec(C, entry):
    if entry is None:
        return None
    target, fm, kw = entry
    return C.FaultSpec(target, fm, **kw)


# -------------------------------------------------------------- bit flips

def _inputs():
    rng = np.random.default_rng(0)
    x8 = rng.integers(-128, 128, (6, 7)).astype(np.int8)
    x8.flat[:3] = [-128, 127, 0]
    x4 = rng.integers(-8, 8, (6, 7)).astype(np.int8)
    xf = (rng.normal(size=(6, 7)) * 100).astype(np.float32)
    xf.flat[:6] = [np.inf, -np.inf, 0.0, -0.0, 1e-40, np.finfo(np.float32).max]
    return {"int8": x8, "int4": x4, "float32": xf, "float16": xf}


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    u = UINT[got.dtype.itemsize]
    np.testing.assert_array_equal(got.view(u), want.view(u))


@pytest.mark.parametrize("kind, nbits", [("int8", 8), ("int4", 4), ("float32", 32),
                                         ("float16", 16)])
def test_flips_bit_equal_to_jax(kind, nbits):
    x = _inputs()[kind]
    jf = getattr(JB, f"flip_{kind}_bit")
    tf = getattr(TB, f"flip_{kind}_bit")
    for bit in range(nbits):
        _same_bits(tf(torch.from_numpy(x), bit).numpy(), jf(jnp.asarray(x), bit))


@pytest.mark.parametrize("kind", ["int8", "int4", "float32", "float16"])
def test_element_and_segment_flips_bit_equal_to_jax(kind):
    x = np.stack([_inputs()[kind]] * 2)            # a lead dim: [2, 6, 7]
    bit = 3
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for idx in (0, 17, x.size - 1):
        _same_bits(TB.flip_element_bit(tx, idx, bit, kind).numpy(),
                   JB.flip_element_bit(jx, idx, bit, kind))
    # in range, overrunning the last column / row, a negative start, a row
    # or column outside the matrix
    for row, start, width in ((1, 2, 3), (5, 5, 4), (0, -2, 4), (6, 0, 3)):
        _same_bits(TB.flip_row_segment(tx, row, start, width, bit, kind).numpy(),
                   JB.flip_row_segment(jx, row, start, width, bit, kind))
    for col, start, height in ((5, 0, 2), (2, 4, 16), (0, -1, 3), (7, 0, 2)):
        _same_bits(TB.flip_col_segment(tx, col, start, height, bit, kind).numpy(),
                   JB.flip_col_segment(jx, col, start, height, bit, kind))


def test_random_value_properties():
    """RANDOM: one element changes, the seed reproduces it, and a NaN bit
    pattern becomes 0."""
    x = torch.ones(3, 5)
    for seed in range(8):
        y = TB.set_random_value(x, torch.Generator().manual_seed(seed))
        assert TB.count_mismatches(x, y) == 1
        assert torch.equal(y, TB.set_random_value(x, torch.Generator().manual_seed(seed)))
        z = TB.flip_random_output_bit(x, torch.Generator().manual_seed(seed), 20)
        assert TB.count_mismatches(x, z) == 1
    vals = TB.random_float32(torch.Generator().manual_seed(0), (20000,))
    raw = torch.randint(-(1 << 31), 1 << 31, (20000,), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    nan = torch.isnan(raw)
    assert int(nan.sum()) > 0 and not bool(torch.isnan(vals).any())
    assert bool((vals[nan] == 0).all())
    assert torch.equal(vals[~nan].view(torch.int32), raw[~nan].view(torch.int32))


# ----------------------------------------------------------------- campaign

@pytest.fixture(scope="module")
def qmodel():
    cfg = dict(src_vocab_size=37, tgt_vocab_size=31, num_layers=2, d_model=32, d_ff=64,
               num_heads=4, dropout=0.0)
    m = Transformer(TransformerConfig(**cfg))
    params = m.init(jax.random.key(21))
    pm = PT.Transformer(PT.TransformerConfig(**cfg))
    pp = params_from_jax(params, device="cpu")
    rng = np.random.default_rng(3)
    src = rng.integers(4, 37, (4, 8)).astype(np.int32)
    sm = np.array(JL.make_src_mask(jnp.asarray(src)))
    return {"m": m, "params": params, "pm": pm, "pp": pp, "src": src, "sm": sm}


def _payloads(q, bits=8):
    pj = JW.quantize_model_params(q["m"], q["params"], bits)
    pt = TW.quantize_model_params(q["pm"], q["pp"], bits)
    for name in pj:
        np.testing.assert_array_equal(pt[name]["wq"].numpy(), np.asarray(pj[name]["wq"]))
    return pj, pt


@pytest.fixture(scope="module")
def jax_tokens(qmodel):
    """JAX's jitted campaign decode of every spec: one compile for the W8A8
    configuration, one for the 4-bit one."""
    m, params = qmodel["m"], qmodel["params"]
    ids = JC.target_ids(m)
    src, sm = jnp.asarray(qmodel["src"]), jnp.asarray(qmodel["sm"])
    out = {}
    for bits, entries in ((8, [None] + SPECS), (4, [BITS4_SPEC])):
        pj, _ = _payloads(qmodel, bits)
        keys = tuple(sorted(pj))
        for entry in entries:
            tree = JC._fault_tree(_spec(JC, entry), ids)
            out[entry and entry[0] + entry[1]] = np.array(JC.faulty_greedy_decode(
                m, keys, params, pj, tree, MAX_LEN, src, sm, bits))
    return out


def _port_decode(q, entry, bits=8, payloads=None):
    pt = payloads if payloads is not None else _payloads(q, bits)[1]
    ids = TC.target_ids(q["pm"])
    return TC.faulty_greedy_decode(q["pm"], tuple(sorted(pt)), q["pp"], pt,
                                   TC._fault_tree(_spec(TC, entry), ids), MAX_LEN,
                                   torch.from_numpy(q["src"]), torch.from_numpy(q["sm"]),
                                   bits).numpy()


def test_disabled_fault_equals_clean_decode(qmodel, jax_tokens):
    """The golden run equals JAX's and the port's KV-cached greedy decode
    under the W8A8 ``int8`` impl (fp32 and int8 cache)."""
    golden = _port_decode(qmodel, None)
    np.testing.assert_array_equal(golden, jax_tokens[None])
    lin = TW.make_w8a8_linear_impl(_payloads(qmodel)[1], "int8")
    src, sm = torch.from_numpy(qmodel["src"]), torch.from_numpy(qmodel["sm"])
    for cache in ("fp32", "int8"):
        clean = greedy_decode(qmodel["pm"], qmodel["pp"], src, sm, MAX_LEN, lin=lin,
                              kv_cache_dtype=cache)
        np.testing.assert_array_equal(clean.numpy(), golden)


@pytest.mark.parametrize("entry", SPECS, ids=[t + ":" + fm for t, fm, _ in SPECS])
def test_faulty_decode_tokens_match_jax(qmodel, jax_tokens, entry):
    np.testing.assert_array_equal(_port_decode(qmodel, entry), jax_tokens[entry[0] + entry[1]])


def test_faulty_decode_4bit_matches_jax(qmodel, jax_tokens):
    np.testing.assert_array_equal(_port_decode(qmodel, BITS4_SPEC, bits=4),
                                  jax_tokens[BITS4_SPEC[0] + BITS4_SPEC[1]])


def _fault_step(m, C, params, payloads, spec, src, sm, golden, on, off):
    """The taps of the faulted pass (encode for an encoder spec, the decode
    step ``inject_step`` for a decoder one, fed the golden tokens up to it)
    and its output.  ``on``/``off``: the framework's active flags."""
    ids = C.target_ids(m)
    fault = C._fault_tree(spec, ids)
    n = m.cfg.num_layers

    def seam(active):
        return {"lin": C.make_fault_linear_impl(payloads, ids, fault, active),
                "inject": C.make_fault_inject(n, ids, fault, active)}

    taps: dict = {}
    if spec.target.startswith("encoder"):
        return taps, m.encode(params, src, sm, taps=taps, **seam(on))
    mem = m.encode(params, src, sm, **seam(off))
    cache = m.init_cache(params, mem, MAX_LEN, lin=seam(off)["lin"], cache_dtype="int8")
    for i in range(spec.inject_step):
        _, cache = m.decode_step(params, cache, golden[:, i:i + 1], i, sm, **seam(off))
    s = spec.inject_step
    logp, _ = m.decode_step(params, cache, golden[:, s:s + 1], s, sm, taps=taps, **seam(on))
    return taps, logp


def _port_fault_step(q, payloads, spec, golden, active=True):
    return _fault_step(q["pm"], TC, q["pp"], payloads, spec, torch.from_numpy(q["src"]),
                       torch.from_numpy(q["sm"]), torch.from_numpy(golden), active, False)


# the tensor that each fault must change (None: the faulted call does not run
# in the faulted pass, as in the JAX package: the cross-attention V is
# projected once, before the decode steps)
FAULTED_SITE = {
    "WEIGHT": ".out", "INPUT16": ".out", "INPUT": ".out", "WEIGHT16": ".out",
    "qk_matmul": "scores", "av_matmul": "context",
}


@pytest.mark.parametrize("entry", SPECS, ids=[t + ":" + fm for t, fm, _ in SPECS])
def test_faulted_step_taps_match_jax(qmodel, jax_tokens, entry):
    """Every tap of the faulted pass, and its output, against JAX's eager
    run of the same pass (tests/test_inject.py:116-141 for the linears,
    :182-220 for the attention matmuls); the faulted tensor itself differs
    from the clean one."""
    q = qmodel
    pj, pt = _payloads(q)
    golden = jax_tokens[None]
    jspec, tspec = _spec(JC, entry), _spec(TC, entry)
    taps_j, out_j = _fault_step(q["m"], JC, q["params"], pj, jspec, jnp.asarray(q["src"]),
                                jnp.asarray(q["sm"]), jnp.asarray(golden), jnp.bool_(True),
                                jnp.bool_(False))
    taps_t, out_t = _port_fault_step(q, pt, tspec, golden)
    assert set(taps_t) == set(taps_j)
    for k, vj in taps_j.items():
        np.testing.assert_allclose(taps_t[k].numpy(), np.asarray(vj), err_msg=k, **TOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)

    clean, _ = _port_fault_step(q, pt, tspec, golden, active=False)
    base, kind = tspec.target.rsplit(".", 1)
    site = (f"{base}.{FAULTED_SITE[kind]}" if kind in FAULTED_SITE
            else tspec.target + FAULTED_SITE[tspec.fault_model])
    if entry[0] == "decoder.layers.0.src_attn.linears.2":
        assert site not in taps_t
    else:
        assert not torch.equal(taps_t[site], clean[site]), site


@pytest.mark.parametrize("target, fm", [
    ("encoder.layers.0.self_attn.qk_matmul", "RANDOM"),
    ("encoder.layers.1.feed_forward.w_1", "RANDOM"),
])
def test_random_fault_changes_one_element_reproducibly(qmodel, target, fm):
    q = qmodel
    _, pt = _payloads(q)
    golden = _port_decode(q, None, payloads=pt)
    spec = TC.FaultSpec(target, fm, seed=11)
    a, _ = _port_fault_step(q, pt, spec, golden)
    b, _ = _port_fault_step(q, pt, spec, golden)
    clean, _ = _port_fault_step(q, pt, spec, golden, active=False)
    site = target + ".out" if "feed_forward" in target else target.rsplit(".", 1)[0] + ".scores"
    assert TB.count_mismatches(a[site], clean[site]) == 1
    assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(_port_decode(q, (target, fm, dict(seed=11)), payloads=pt),
                                  _port_decode(q, (target, fm, dict(seed=11)), payloads=pt))


def test_decoder_fault_fires_only_at_its_step(qmodel, monkeypatch):
    """The linear impl and the inject dict are active at the spec's decode
    step only, never in the encoder or the cross-K/V; a step past max_len
    never fires."""
    q = qmodel
    _, pt = _payloads(q)
    flags = []
    make_lin, make_inj = TC.make_fault_linear_impl, TC.make_fault_inject

    def lin(payloads, ids, fault, active, bits=8):
        flags.append(("lin", active))
        return make_lin(payloads, ids, fault, active, bits)

    def inj(n, ids, fault, active, bits=8):
        flags.append(("inject", active))
        return make_inj(n, ids, fault, active, bits)

    monkeypatch.setattr(TC, "make_fault_linear_impl", lin)
    monkeypatch.setattr(TC, "make_fault_inject", inj)
    spec = ("decoder.layers.0.self_attn.linears.0", "WEIGHT16", dict(bit=7, inject_step=4))
    _port_decode(q, spec, payloads=pt)
    # encode (lin, inject), cross-K/V (lin), then (lin, inject) per step
    steps = [a for kind, a in flags[3:] if kind == "lin"]
    assert [a for _, a in flags[:3]] == [False, False, False]
    assert steps == [i == 4 for i in range(MAX_LEN - 1)]
    monkeypatch.undo()
    golden = _port_decode(q, None, payloads=pt)
    never = ("decoder.layers.0.self_attn.linears.0", "WEIGHT16", dict(bit=7, inject_step=99))
    np.testing.assert_array_equal(_port_decode(q, never, payloads=pt), golden)


def test_batch_equals_serial(qmodel):
    q = qmodel
    _, pt = _payloads(q)
    ids = TC.target_ids(q["pm"])
    keys = tuple(sorted(pt))
    entries = [SPECS[0], SPECS[1], ("encoder.layers.1.self_attn.qk_matmul", "RANDOM",
                                    dict(seed=5)), None]
    src, sm = torch.from_numpy(q["src"]), torch.from_numpy(q["sm"])
    batch = TC.faulty_greedy_decode_batch(q["pm"], keys, q["pp"], pt,
                                          [TC._fault_tree(_spec(TC, e), ids) for e in entries],
                                          MAX_LEN, src, sm)
    assert batch.shape == (len(entries), 4, MAX_LEN)
    for e, entry in enumerate(entries):
        np.testing.assert_array_equal(batch[e].numpy(), _port_decode(q, entry, payloads=pt))


def test_target_ids_match_jax(qmodel):
    ids = TC.target_ids(qmodel["pm"])
    assert ids == JC.target_ids(qmodel["m"])
    assert len(TC.target_ids(PT.Transformer(PT.TransformerConfig(37, 31)))) == 96 + 36
    assert TC.FAULT_MODELS == JC.FAULT_MODELS


@pytest.mark.parametrize("module, layer, want", [
    ("Encoder/FirstMatMul", "MatMul_3", "encoder.layers.0.self_attn.qk_matmul"),
    ("Encoder/SecondMatMul", "MatMul_36", "encoder.layers.4.self_attn.av_matmul"),
    ("Encoder/FirstFC", "MatMul_30", "encoder.layers.3.feed_forward.w_1"),
    ("Encoder/SecondFC", "MatMul_7", "encoder.layers.0.feed_forward.w_2"),
    ("Decoder/FirstMatMul", "MatMul_15", "decoder.layers.0.self_attn.qk_matmul"),
    ("Decoder/FirstMatMul", "MatMul_19", "decoder.layers.0.src_attn.qk_matmul"),
    ("Decoder/SecondMatMul", "MatMul_80", "decoder.layers.5.src_attn.av_matmul"),
    ("Decoder/SecondFC", "MatMul_83", "decoder.layers.5.feed_forward.w_2"),
])
def test_reference_descriptor_mapping(module, layer, want):
    assert TC.reference_matmul_to_target(module, layer) == want
    assert JC.reference_matmul_to_target(module, layer) == want


def test_specs_from_reference_jsons(tmp_path):
    d = tmp_path / "encoder"
    d.mkdir()
    for name, desc in (("matmul_3.json", {"module": "Encoder/FirstMatMul",
                                          "target_layer": "MatMul_3"}),
                       ("matmul_30.json", {"module": "Encoder/FirstFC",
                                           "target_layer": "MatMul_30"})):
        (d / name).write_text(json.dumps(desc))
    (d / "notes.txt").write_text("not a descriptor")
    extra = tmp_path / "dec.json"
    extra.write_text(json.dumps({"module": "Decoder/SecondFC", "target_layer": "MatMul_83"}))
    for path in (str(d), [str(d), str(extra)]):
        got = TC.specs_from_reference_jsons(path, fault_models=("INPUT", "RANDOM"),
                                            bit_positions=(0, 7), inject_step=2, seed=4)
        want = JC.specs_from_reference_jsons(path, fault_models=("INPUT", "RANDOM"),
                                             bit_positions=(0, 7), inject_step=2, seed=4)
        assert [vars(s) for s in got] == [vars(s) for s in want]
    assert len(got) == 3 * 2 * 2
    assert {s.ref_name for s in got} == {"MatMul_3", "MatMul_30", "MatMul_83"}
    ids = TC.target_ids(PT.Transformer(PT.TransformerConfig(37, 31)))
    assert all(s.target in ids for s in got)


class _Vocab:
    itos = ["<s>", "</s>", "<blank>", "<unk>"] + [f"t{i}" for i in range(27)]


def test_campaign_csv_schemas(qmodel, jax_tokens, tmp_path):
    """``full``: a header and five columns; ``reference``: three headerless
    columns with the descriptor's MatMul name where the spec came from one
    (as ``results_fault_injection/results_reference_format.csv``).  The
    BLEUs are those of JAX's tokens under JAX's BLEU."""
    q = qmodel
    _, pt = _payloads(q)
    entries = [SPECS[0], SPECS[4], SPECS[1]]
    specs = [_spec(TC, e) for e in entries]
    specs[1].ref_name = "MatMul_11"
    refs = [["t1", "t2", "t3", "t4"], ["t3"], ["t4", "t5"], jax_ids_to_tokens(
        jax_tokens[None], _Vocab)[3]]
    logs = []
    paths = {fmt: str(tmp_path / fmt / "results.csv") for fmt in TC.CSV_FORMATS}
    src, sm = torch.from_numpy(q["src"]), torch.from_numpy(q["sm"])
    res = TC.run_campaign(q["pm"], q["pp"], pt, specs, src, sm, refs, _Vocab,
                          max_len=MAX_LEN, csv_path=paths["full"], fanout=2,
                          log_fn=logs.append)
    TC.write_csv(res.rows, paths["reference"], "reference")
    rows = {fmt: list(csv.reader(open(p))) for fmt, p in paths.items()}
    assert rows["full"][0] == ["layer", "golden_bleu", "faulty_bleu", "bit", "fault_model"]
    assert len(rows["full"]) == 1 + 3 * 4 and all(len(r) == 5 for r in rows["full"])
    assert len(rows["reference"]) == 3 * 4 and all(len(r) == 3 for r in rows["reference"])
    assert [r[0] for r in rows["reference"]] == (
        [specs[0].target] * 4 + ["MatMul_11"] * 4 + [specs[2].target] * 4)
    golden_toks = jax_ids_to_tokens(jax_tokens[None], _Vocab)
    for e, entry in enumerate(entries):
        faulty = jax_ids_to_tokens(jax_tokens[entry[0] + entry[1]], _Vocab)
        for gi in range(4):
            row = rows["full"][1 + 4 * e + gi]
            assert row[0] == entry[0] and row[3] == str(specs[e].bit) and row[4] == entry[1]
            assert float(row[1]) == JBLEU.sentence_bleu([refs[gi]], golden_toks[gi],
                                                        smoothing="method4")
            assert float(row[2]) == JBLEU.sentence_bleu([refs[gi]], faulty[gi],
                                                        smoothing="method4")
            assert rows["reference"][4 * e + gi][1:] == row[1:3]
    assert len(res.groups) == 2 and [e for e, _ in res.groups] == [2, 1]
    np.testing.assert_array_equal(res.golden, jax_tokens[None])
    assert len(res.faulty) == 3 and len(logs) == 2
    with pytest.raises(ValueError):
        TC.run_campaign(q["pm"], q["pp"], pt, specs, src, sm, refs, _Vocab,
                        max_len=MAX_LEN, csv_path=paths["full"], csv_format="json")
