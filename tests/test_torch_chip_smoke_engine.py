"""chip_smoke.py's "engine" phase rehearsed on the CPU at a tiny size
(``tests/chip_smoke_rehearsal.py``): the launch arithmetic of its three
runs, and a lost and a wrong request caught by its gates.  The other
phases' rehearsals are in ``test_torch_chip_smoke.py``."""

import pytest

import chip_smoke as C
from chip_smoke_rehearsal import CPU, rehearsal  # noqa: F401  (a fixture)
from onnx_transformer_tpu_torch.quant import w8a8 as TW


ENGINE_TINY = dict(slots=8, seq=9, buckets=(3, 6, 9), chunk=3, requests=(20, 20, 8))


def test_engine_launch_arithmetic(rehearsal, monkeypatch):
    """The engine phase at 2 layers, 8 slots and sources of 9: with the
    token threshold at 30, E1's and E2's prefills of 8 x 6 and 8 x 9 tokens
    take K1/K2 and those of 8 x 3 do not, E3's (4 rows each) only at 4 x 9;
    no decode step (8 tokens) does.  E1 takes the fast chunk (no kernel in
    its chunks), E2 K5 for every quantized linear and K3 for every
    attention step, E3 the beam chunk; each gives the lockstep tokens."""
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 30)
    base = C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)
    res = C.run_engine_path(CPU, base, card="cpu", **ENGINE_TINY)
    zero = dict.fromkeys(C.MATMUL_COUNTERS, 0) | {"attn": 0}
    e1, e2, e3 = (res[label] for label, *_ in C.ENGINE_RUNS)
    pre = e1["dispatch"]["prefill"]
    assert {k for k, _ in pre} == {8} and {sb for _, sb in pre} == {3, 6, 9}
    big = sum(sb >= 6 for _, sb in pre)
    assert e1["launches"] == zero | {"qout": 6 * big, "q8": 4 * big}
    steps = 3 * e2["dispatch"]["chunk"]
    assert e2["launches"] == zero | {"w8a8": 16 * len(e2["dispatch"]["prefill"]) + 16 * steps,
                                     "attn": 4 * steps}
    pre3 = e3["dispatch"]["prefill"]
    assert {k for k, _ in pre3} == {4} and 9 in {sb for _, sb in pre3}
    big3 = sum(sb == 9 for _, sb in pre3)
    assert big3 < len(pre3) and e3["launches"] == zero | {"qout": 6 * big3, "q8": 4 * big3}
    for r in res.values():
        assert r["agree"] == r["identical"] == 1.0 and 0 < r["occupancy"] <= 1


def test_engine_gate_catches_a_lost_request(rehearsal, monkeypatch):
    """An engine that loses one completion fails the phase."""
    from onnx_transformer_tpu_torch.serving import engine as TE

    real = TE.TranslationEngine._drain_report
    lost = []

    def losing(self, report):
        finished = real(self, report)
        if finished and not lost:
            lost.append(finished.pop())
        return finished

    monkeypatch.setattr(TE.TranslationEngine, "_drain_report", losing)
    base = C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)
    with pytest.raises(AssertionError, match="19 requests back of 20"):
        C.run_engine_path(CPU, base, card="cpu", **ENGINE_TINY)
    assert len(lost) == 1


def test_engine_gate_catches_a_wrong_request(rehearsal, monkeypatch):
    """An engine that gets one whole request wrong (here its last token
    lost) keeps the per-token agreement above 0.95 but fails the run's
    least share of identical requests, set to 1.0 here."""
    from onnx_transformer_tpu_torch.serving import engine as TE

    real = TE.TranslationEngine._drain_report
    cut = []

    def cutting(self, report):
        finished = real(self, report)
        if finished and not cut:
            cut.append(finished[0].out_tokens.pop())
        return finished

    monkeypatch.setattr(TE.TranslationEngine, "_drain_report", cutting)
    monkeypatch.setattr(C, "ENGINE_RUNS", tuple(r[:4] + (1.0,) for r in C.ENGINE_RUNS))
    base = C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)
    with pytest.raises(AssertionError, match="E1 fast: requests identical 0.95 < 1.0"):
        C.run_engine_path(CPU, base, card="cpu", **ENGINE_TINY)
    assert len(cut) == 1
