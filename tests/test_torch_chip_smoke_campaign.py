"""chip_smoke.py's "fault campaign" phase rehearsed on the CPU at a tiny
size (``tests/chip_smoke_rehearsal.py``): calibration, SmoothQuant, W8A8,
the campaign's gates and no kernel launch in it, and the check of the
kernels' routing with a broken gate caught.  The other phases' rehearsals
are in ``test_torch_chip_smoke.py``."""

import os
import tempfile

import pytest

import chip_smoke as C
from chip_smoke_rehearsal import CPU, rehearsal  # noqa: F401  (a fixture)
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM
from onnx_transformer_tpu_torch.quant import w8a8 as TW


def test_fault_campaign_launches_no_kernel(rehearsal, monkeypatch):
    """The fault campaign phase at 2 layers (its six specs' layers taken
    modulo the depth): calibration, SmoothQuant, W8A8, the golden decode
    twice, the batch against the serial decodes, the WEIGHT fault's one
    column, both CSVs (written outside the repository) with their BLEUs,
    and no K1-K8 launch in the campaign.  With the token threshold at 1
    the routing check's tiny encoder takes K1/K2 (fused W8A8) and K6/K7
    (W4A8), and its decode step K3, without a seam, and none of them with
    ``taps={}`` or ``inject={}``."""
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 1)
    dirs = []
    real = tempfile.TemporaryDirectory

    class Recorded(real):
        def __enter__(self):
            dirs.append(super().__enter__())
            return dirs[-1]

    monkeypatch.setattr(tempfile, "TemporaryDirectory", Recorded)
    base = C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)
    res = C.run_fault_campaign(CPU, base, card="cpu", batch=4, src_len=9, max_len=8,
                               fanout=4, calib=(2, 4, 9))
    assert res["launches"] == dict.fromkeys(C.MATMUL_COUNTERS, 0) | {"attn": 0}
    # at the threshold of 1: q/k/v of each encoder layer, and the step's
    # self q/k/v and cross q of each decoder layer; the cross-K/V and the two
    # attentions of each decoder layer
    for label, qout, q8 in (("w8a8 fused", "qout", "q8"), ("w4a8", "qout4", "q84")):
        assert res["routing"][label, "none"] == {qout: (3 + 4) * 2, q8: 2 * 2, "attn": 2 * 2}
        assert res["routing"][label, "taps"] == res["routing"][label, "inject"] == {}
    assert res["rows"] == len(C.CAMPAIGN_SPECS) * 4
    assert res["weight_columns"] == 1 and res["agree"] == 1.0
    repo = os.path.dirname(os.path.abspath(C.__file__))
    assert len(dirs) == 1 and not os.path.abspath(dirs[0]).startswith(repo + os.sep)
    assert not os.path.exists(dirs[0])
    # the gates raise: a kernel launch in the campaign fails the phase
    monkeypatch.setattr(C, "MATMUL_COUNTERS", {"qout": "quant_w8a8_matmul_qout"})
    launched = KM.quant_w8a8_matmul_qout
    real_decode = C.weight_fault_columns

    def launching(*a, **k):
        launched.launches += 1
        return real_decode(*a, **k)

    monkeypatch.setattr(C, "weight_fault_columns", launching)
    with pytest.raises(AssertionError, match="launched in the fault campaign"):
        C.run_fault_campaign(CPU, base, card="cpu", batch=4, src_len=9, max_len=8,
                             fanout=4, calib=(2, 4, 9))


@pytest.mark.parametrize("gate", ["_fused_ok", "_k6_ok"])
def test_kernel_routing_catches_a_broken_gate(rehearsal, monkeypatch, gate):
    """A linear impl's kernel gate that ignores the seam fails the routing
    check: the kernel launches under taps or inject."""
    from onnx_transformer_tpu_torch.quant import int4 as TI

    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 1)
    module = TW if gate == "_fused_ok" else TI
    real = getattr(module, gate)
    monkeypatch.setattr(module, gate, lambda p, name, x, bits, taps=None, inject=None:
                        real(p, name, x, bits))
    base = C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)
    with pytest.raises(AssertionError, match="kernel routing"):
        C.check_kernel_routing(base["model"], base["params"], base["payloads"], CPU, 9)
