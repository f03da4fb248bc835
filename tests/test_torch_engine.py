"""Port of serving/engine.py against the JAX package, case for case with
tests/test_engine.py (the TP mesh is in tests/test_torch_engine_tp.py): the same numpy sources and the same JAX weights go through the
JAX package's lockstep ``greedy_decode``/``beam_decode``, which the JAX
tests hold the JAX engine to, and through the port's engine, which must
give identical token ids per request.  The fast-chunk, beam and bucketed
cases are also held against the JAX ``TranslationEngine``'s own output,
and the fast chunk must be taken exactly where the JAX engine takes it.
On the CPU every kernel wrapper takes its plain version (K3 under
``fused_attn``, K5 under mode "pallas")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import int4 as JI
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu.serving import decode as JD
from onnx_transformer_tpu.serving import engine as JE
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.quant import int4 as TI
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving import engine as TE

DIMS = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4)


def _pair(src_vocab, tgt_vocab, seed):
    m = Transformer(TransformerConfig(src_vocab, tgt_vocab, dropout=0.0, **DIMS))
    params = m.init(jax.random.key(seed))
    return m, params, PT.Transformer(PT.TransformerConfig(src_vocab, tgt_vocab, **DIMS)), \
        params_from_jax(params, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """tests/test_engine.py:15-28, plus the port's model and weights."""
    m, params, pm, pp = _pair(31, 29, 5)
    rng = np.random.default_rng(2)
    srcs = rng.integers(4, 31, (9, 10)).astype(np.int32)
    srcs[3, -4:] = 2
    srcs[7, -2:] = 2
    return {"jax": (m, params), "torch": (pm, pp), "srcs": srcs, "memo": {}}


@pytest.fixture(scope="module")
def fast_setup():
    """tests/test_engine.py:294-303: the fast chunk's config."""
    m, params, pm, pp = _pair(37, 31, 11)
    rng = np.random.default_rng(3)
    src = rng.integers(4, 37, (10, 8)).astype(np.int32)
    src[2, -3:] = 2
    return {"jax": (m, params), "torch": (pm, pp), "srcs": src, "memo": {}}


@pytest.fixture(scope="module")
def eos_setup(fast_setup):
    """The fast chunk's model with the generator's EOS bias raised by 0.7,
    so that outputs end at every length from 0 to the cap (the seeded
    models above never emit EOS), and 24 sources."""
    m, params = fast_setup["jax"]
    params = jax.tree_util.tree_map(np.asarray, params)
    bias = params["generator"]["b"].copy()
    bias[m.cfg.eos_id] += 0.7
    params["generator"]["b"] = bias
    src = np.random.default_rng(3).integers(4, 37, (24, 8)).astype(np.int32)
    return {"jax": (m, params), "memo": {}, "srcs": src,
            "torch": (fast_setup["torch"][0], params_from_jax(params, device="cpu"))}


def _trim(row, cfg):
    toks = []
    for t in row[1:]:
        if t == cfg.eos_id or t == cfg.pad_id:
            break
        toks.append(int(t))
    return toks


def _jax_lin(s, mode):
    """The JAX model's (params, lin) under a W8A8 mode, or the fp32 model."""
    m, params = s["jax"]
    if mode is None:
        return params, None
    return JW.quantize_transformer(m, params, mode=mode)


def _torch_lin(s, mode):
    pm, pp = s["torch"]
    if mode is None:
        return pp, PT.default_linear
    return TW.quantize_transformer(pm, pp, mode=mode)


def _lockstep(s, max_len, mode=None, kv="fp32", fused=False, reps=1, beam=0):
    """The JAX package's lockstep decode of ``reps`` copies of the sources,
    each row trimmed as the engine trims (memoised per module)."""
    key = (max_len, mode, kv, fused, reps, beam)
    if key not in s["memo"]:
        m = s["jax"][0]
        params, lin = _jax_lin(s, mode)
        src = jnp.asarray(np.concatenate([s["srcs"]] * reps))
        sm = JL.make_src_mask(src)
        kw = {"lin": lin} if lin is not None else {}
        if beam:
            ys = JD.beam_decode(m, params, src, sm, max_len, beam_size=beam,
                                kv_cache_dtype=kv, **kw)
        else:
            ys = JD.greedy_decode(m, params, src, sm, max_len, kv_cache_dtype=kv,
                                  fused_attn=fused, **kw)
        s["memo"][key] = [_trim(r, m.cfg)[: max_len - 1] for r in np.asarray(ys)]
    return s["memo"][key]


def _run(eng, srcs, **kw):
    ids = [eng.submit(r) for r in srcs]
    done = eng.run(**kw)
    assert all(r.done for r in done)
    assert sorted(r.req_id for r in done) == sorted(ids), "a request lost or repeated"
    got = {r.req_id: r.out_tokens for r in done}
    return [got[i] for i in ids]


def _engine(s, mode=None, **kw):
    pm = s["torch"][0]
    params, lin = _torch_lin(s, mode)
    return TE.TranslationEngine(pm, params, lin=lin, src_len=s["srcs"].shape[1], **kw)


def _jax_engine(s, mode=None, **kw):
    m = s["jax"][0]
    params, lin = _jax_lin(s, mode)
    lin_kw = {"lin": lin} if lin is not None else {}
    return JE.TranslationEngine(m, params, src_len=s["srcs"].shape[1], **lin_kw, **kw)


def test_engine_matches_batched_greedy(setup):
    eng = _engine(setup, num_slots=4, max_len=12, chunk_steps=3)
    assert _run(eng, setup["srcs"]) == _lockstep(setup, 12)


def test_engine_more_requests_than_slots_reuses_slots(setup):
    eng = _engine(setup, num_slots=2, max_len=8, chunk_steps=2)
    got = _run(eng, setup["srcs"])
    assert all(len(t) <= 7 for t in got)
    assert got == _lockstep(setup, 8)


def test_engine_incremental_submission(setup):
    eng = _engine(setup, num_slots=3, max_len=12, chunk_steps=4)
    want = _lockstep(setup, 12)
    assert _run(eng, setup["srcs"][:1]) == want[:1]
    # the engine is reusable: a second wave afterwards
    assert _run(eng, setup["srcs"][1:3]) == want[1:3]


def test_engine_int8_kv_cache_matches_fp_under_w8a8(setup):
    """Both on the general chunk (12 % 5 != 0)."""
    kw = dict(num_slots=3, max_len=12, chunk_steps=5)
    got_fp = _run(_engine(setup, "int8", **kw), setup["srcs"][:5])
    eng = _engine(setup, "int8", kv_cache_dtype="int8", **kw)
    assert eng._stacked is None
    got_i8 = _run(eng, setup["srcs"][:5])
    assert got_fp == got_i8 == _lockstep(setup, 12, "int8", "int8")[:5]


@pytest.mark.parametrize("mode", ["int8", "pallas"])
def test_engine_fused_attn_int8_matches_lockstep(setup, mode):
    """int8 cache with ``fused_attn`` (K3's plain version here), under mode
    int8, held to the lockstep decode without it (the JAX test's contract:
    the fused engine equals the jnp one), and under mode pallas (K5's plain
    version), held to JAX's lockstep decode through its interpreted Pallas
    kernels: slots at heterogeneous positions exercise the per-row masks."""
    eng = _engine(setup, mode, num_slots=4, max_len=12, chunk_steps=3, kv_cache_dtype="int8",
                  fused_attn=True)
    assert eng._stacked is None
    assert _run(eng, setup["srcs"]) == _lockstep(setup, 12, mode, "int8",
                                                 fused=mode == "pallas")


def test_engine_batched_prefill_matches_single(setup):
    """One encoder dispatch per ``prefill_chunk`` requests, the padding
    entries dropped into the staging ring's spare row; 9 > num_slots is
    clamped, so padded groups are exercised."""
    want = _lockstep(setup, 12)
    for chunk in (1, 4, 9):
        eng = _engine(setup, num_slots=4, max_len=12, chunk_steps=3, prefill_chunk=chunk)
        assert _run(eng, setup["srcs"]) == want, chunk


def test_engine_bucketed_prefill_matches_full_length(setup):
    """Encoding at the bucket length equals full-length encoding (masked pad
    positions contribute exact zeros); the JAX engine agrees."""
    kw = dict(num_slots=4, max_len=12, chunk_steps=3, prefill_chunk=4, buckets=(6, 8, 10))
    eng = _engine(setup, **kw)
    assert eng.buckets == [6, 8, 10]
    got = _run(eng, setup["srcs"])
    assert got == _lockstep(setup, 12)
    assert got == _run(_jax_engine(setup, **kw), setup["srcs"])


def test_engine_staging_ring_wraparound(setup):
    """27 requests through a staging ring of 3: it wraps and every request
    completes exactly once, with the lockstep tokens."""
    eng = _engine(setup, num_slots=2, max_len=8, chunk_steps=2, prefill_chunk=2,
                  stage_capacity=3)
    assert _run(eng, list(setup["srcs"]) * 3) == _lockstep(setup, 8, reps=3)


def test_engine_time_major_cache_matches_lockstep(setup):
    eng = _engine(setup, "int8", num_slots=4, max_len=12, chunk_steps=3, kv_cache_dtype="int8",
                  kv_time_major=True)
    assert eng._tm and eng._state is None
    assert _run(eng, setup["srcs"]) == _lockstep(setup, 12, "int8", "int8")
    assert eng._state["cache"]["layers"][0]["k"].shape == (12, 4, 32)


def test_bucketed_fleet_matches_single_engine(setup):
    """Per-bucket pools emit the single full-length engine's (the lockstep)
    tokens for every request."""
    pm, pp = setup["torch"]
    fleet = TE.BucketedEngineFleet(pm, pp, pools=((6, 2, 12), (8, 3, 12), (10, 4, 12)),
                                   chunk_steps=3)
    ids = [fleet.submit(s) for s in setup["srcs"]]
    done = fleet.run()
    got = {r.req_id: r.out_tokens for r in done}
    assert len(done) == len(got) == len(setup["srcs"])
    assert [got[i] for i in ids] == _lockstep(setup, 12)
    # the short sources went to the short pools
    assert sum(e.occ_slot_steps > 0 for e in fleet.engines.values()) >= 2


def test_engine_chaos_small_rings_interleaved_waves(setup):
    """A tiny slot pool, staging ring and completion cadence, requests in
    interleaved waves: every request completes exactly once with the
    lockstep tokens."""
    eng = _engine(setup, num_slots=3, max_len=8, chunk_steps=2, prefill_chunk=2,
                  stage_capacity=4, buckets=(7, 10))
    pool = list(np.concatenate([setup["srcs"]] * 3))
    got, ids = {}, []
    rng = np.random.default_rng(0)
    while pool or len(got) < len(ids):
        for _ in range(min(len(pool), int(rng.integers(1, 7)))):
            ids.append(eng.submit(pool.pop(0)))
        for r in eng.run(pipeline_depth=2, drain_every=2):
            assert r.req_id not in got, "duplicate completion"
            got[r.req_id] = r.out_tokens
    assert len(got) == len(ids) == 27
    assert [got[i] for i in ids] == _lockstep(setup, 8, reps=3)


@pytest.mark.parametrize("mode", ["int8", "fused"])
def test_fast_chunk_path_matches_lockstep_int8(fast_setup, mode):
    """The chunk-staged fast chunk (int8 cache, int8 W8A8 payloads) gives
    the lockstep tokens and the JAX engine's; mode fused takes it too (its
    kernels K1/K2 only in the prefill, their plain versions here)."""
    kw = dict(num_slots=4, max_len=12, chunk_steps=3, kv_cache_dtype="int8")
    eng = _engine(fast_setup, mode, **kw)
    assert eng._stacked is not None, "fast path not engaged"
    got = _run(eng, fast_setup["srcs"])
    assert got == _lockstep(fast_setup, 12, "int8", "int8")
    if mode == "int8":
        assert got == _run(_jax_engine(fast_setup, "int8", **kw), fast_setup["srcs"])


@pytest.mark.parametrize("mode,kw", [
    (None, dict()),
    ("int8", dict(kv_cache_dtype="int8", chunk_steps=6, refill_every=2)),
    (None, dict(beam_size=2)),
])
def test_engine_deaths_at_every_length_match_lockstep(eos_setup, mode, kw):
    """Requests that end at every length, so that slots die and refill at
    staggered steps (in the fast chunk also between its mid-chunk refills,
    where a completion shows the ring as it stood at the death step)."""
    args = dict(dict(num_slots=4, max_len=12, chunk_steps=3), **kw)
    eng = _engine(eos_setup, mode, **args)
    assert (eng._stacked is not None) == (args["chunk_steps"] == 6)
    got = _run(eng, eos_setup["srcs"])
    lens = {len(t) for t in got}
    assert 0 in lens and 11 in lens and len(lens) >= 5
    want = _lockstep(eos_setup, 12, mode, kw.get("kv_cache_dtype", "fp32"),
                     beam=kw.get("beam_size", 0))
    assert got == want


def test_int4_impl_uses_general_path():
    """W4A8 payloads carry 'wq_packed': the engine takes the general chunk
    and serves the lockstep int4 tokens."""
    m, params, pm, pp = _pair(37, 31, 4)
    src = np.random.default_rng(5).integers(4, 37, (6, 8)).astype(np.int32)
    lin4 = TI.make_w4a8_linear_impl(TI.quantize_model_params_int4(pm, pp), fused=False)
    eng = TE.TranslationEngine(pm, pp, lin=lin4, num_slots=4, src_len=8, max_len=12,
                               chunk_steps=3, kv_cache_dtype="int8")
    assert eng._stacked is None, "int4 impl must not use the int8 fast path"
    jlin4 = JI.make_w4a8_linear_impl(JI.quantize_model_params_int4(m, params), fused=False)
    jsrc = jnp.asarray(src)
    ys = np.asarray(JD.greedy_decode(m, params, jsrc, JL.make_src_mask(jsrc), 12, lin=jlin4,
                                     kv_cache_dtype="int8"))
    assert _run(eng, src) == [_trim(r, m.cfg)[:11] for r in ys]


@pytest.mark.parametrize("mode,kw", [
    ("int8", dict(kv_cache_dtype="int8")),
    ("fused", dict(kv_cache_dtype="int8")),
    ("pallas", dict(kv_cache_dtype="int8")),
    ("fake", dict(kv_cache_dtype="int8")),
    ("int8", dict()),
    ("int8", dict(kv_cache_dtype="int8", fused_attn=True)),
    ("int8", dict(kv_cache_dtype="int8", kv_time_major=True)),
    ("int8", dict(kv_cache_dtype="int8", chunk_steps=5)),
    ("int8", dict(kv_cache_dtype="int8", beam_size=2)),
    (None, dict(kv_cache_dtype="int8")),
])
def test_fast_chunk_taken_where_jax_takes_it(fast_setup, mode, kw):
    args = dict(dict(num_slots=4, max_len=12, chunk_steps=3), **kw)
    want = _jax_engine(fast_setup, mode, **args)._stacked is not None
    assert (_engine(fast_setup, mode, **args)._stacked is not None) == want
    assert want == (mode in ("int8", "fused") and len(kw) == 1)


def test_engine_beam_matches_lockstep_beam(setup):
    """Slot-group beam engine (K slots per request, ancestry-gathered
    self-KV ring): the lockstep beam_decode's best hypothesis per request,
    and the JAX beam engine's."""
    kw = dict(num_slots=8, max_len=12, chunk_steps=3, beam_size=4)
    got = _run(_engine(setup, **kw), setup["srcs"])
    assert got == _lockstep(setup, 12, beam=4)
    assert got == _run(_jax_engine(setup, **kw), setup["srcs"])


def test_engine_beam_int8_matches_lockstep_beam(setup):
    eng = _engine(setup, "int8", num_slots=9, max_len=12, chunk_steps=4, kv_cache_dtype="int8",
                  beam_size=3)
    assert _run(eng, setup["srcs"]) == _lockstep(setup, 12, "int8", "int8", beam=3)


def test_engine_beam_more_requests_than_groups(setup):
    eng = _engine(setup, num_slots=4, max_len=8, chunk_steps=2, beam_size=2)
    got = _run(eng, setup["srcs"])
    assert all(len(t) <= 7 for t in got)
    assert got == _lockstep(setup, 8, beam=2)


def test_complete_harvest_remainder_fetch(setup):
    """When the sized harvest copy undercounts, the remainder rows come
    exactly from the retained device report."""
    eng = _engine(setup, num_slots=4, max_len=8, chunk_steps=2)
    full = torch.arange(9 * 7, dtype=torch.int32).reshape(9, 7)
    full[0, 0] = 6                    # the header says 6 completions
    rep = full[:4].numpy().copy()     # a copy sized to 3 rows only
    out = eng._complete_harvest(rep, [full])
    assert out.shape[0] == 7          # header + 6 rows
    np.testing.assert_array_equal(out, full[:7].numpy())
    rep2 = full[:7].numpy().copy()    # exact size: no more copy
    np.testing.assert_array_equal(eng._complete_harvest(rep2, [full]), rep2)


def test_backpressure_gates_refills_but_loses_nothing(setup):
    """A tiny completion buffer engages the refill backpressure (gated
    slots) without losing a completion."""
    eng = _engine(setup, num_slots=4, max_len=8, chunk_steps=2, comp_capacity=16)
    got = _run(eng, list(setup["srcs"]) * 3, drain_every=8)
    assert eng.gated_slots > 0
    assert got == _lockstep(setup, 8, reps=3)


def test_engine_drops_lose_no_request(setup):
    """Every write the JAX engine drops by an out-of-range index lands in a
    spare row here: padded prefill groups (ring row R), a full staging ring
    (admission waits), rows that do not die and refills gated by the
    completion buffer (comp row C).  No request is lost, every token is the
    lockstep's, and the spare rows were written."""
    eng = _engine(setup, num_slots=4, max_len=8, chunk_steps=2, prefill_chunk=3,
                  stage_capacity=4, comp_capacity=10, buckets=(7, 10))
    srcs = list(setup["srcs"]) * 3
    assert _run(eng, srcs, drain_every=6) == _lockstep(setup, 8, reps=3)
    st = eng._state
    assert eng.R == 4 and st["stage"]["tag"].shape == (5,)
    # a padding row's encoded cross-K is not zero
    assert bool(st["stage"]["layers"][0]["cross_k"][4].any()), "no padding entry was dropped"
    assert st["comp"].shape[0] == eng._C + 1 and bool((st["comp"][eng._C] != 0).any())
    assert eng.gated_slots > 0 and eng.starved_slots > 0


def test_engine_runs_on_the_device_of_params(setup):
    """State, reports and every kernel call stay on the params' device; a
    source of the wrong length is refused."""
    eng = _engine(setup, num_slots=4, max_len=8, chunk_steps=2)
    with pytest.raises(ValueError, match="padded to 10"):
        eng.submit(setup["srcs"][0][:5])
    _run(eng, setup["srcs"][:2])
    assert eng.device == torch.device("cpu")
    assert eng._state["comp"].device == eng._state["cache"]["layers"][0]["k"].device == eng.device
    assert isinstance(eng._state["g"], int) and eng._state["g"] % 2 == 0
