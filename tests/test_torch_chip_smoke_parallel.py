"""chip_smoke.py's phase "parallel" rehearsed on the CPU at a tiny size
(IWSLT14-base widths, 1 + 1 layers, 4 slots, sources of 9): the one-device
reference and a world of one rank in this process (over gloo here, nccl on
the card), then two spawned ranks over gloo, every gate of
``check_parallel`` held.  The kernel wrappers are wrapped to count in this
process (the spawned ranks take the plain versions and count nothing on
the CPU, so their launch gate runs on the card only).  Then each gate on
results made wrong on purpose, K5's expected launches, and the ranks'
cleanup when they raise."""

import copy
import multiprocessing

import pytest
import torch
from test_torch_chip_smoke import install_rehearsal

import chip_smoke as C
import onnx_transformer_tpu_torch as P

CPU = torch.device("cpu")
TINY = dict(layers=1, slots=4, requests=6, seq=9, chunk=3, buckets=(3, 6, 9))


@pytest.fixture(scope="module")
def phase_runs():
    """The phase's runs, rehearsed once for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        install_rehearsal(mp)
        return C.run_parallel_path(CPU, card="cpu", sizes=TINY, one_backend="gloo",
                                   timeout_s=300)


def test_parallel_phase_rehearsal(phase_runs):
    one, two, ref = phase_runs["one"], phase_runs["two"], phase_runs["reference"]
    assert one["outs"] == two["outs"] == ref["outs"] and len(ref["outs"]) == 6
    assert one["launches"] == C.tp_expected(1, one["prefills"], one["steps"])
    assert one["launches"]["w8a8"] > 0 and one["chunk"] == "_chunk_fn"
    assert two["kv_bytes"] * 2 == ref["kv_bytes"] == one["kv_bytes"]
    # on the CPU the logits of both views are bit-equal, at each batch
    assert len(two["ranks"]) == 2 and len(two["ranks"][1]["logits"]) == 2 * C.TP_LOGIT_STEPS
    for run in (one, two):
        assert run["logit_diff"] == {rows: [0.0] * C.TP_LOGIT_STEPS
                                     for rows in C.TP_LOGIT_ROWS}
    # a collective sums every row-parallel product and takes each sharded
    # row's maximum
    assert two["collectives"]["model_sum"][0] > 0 and two["collectives"]["model_max"][0] > 0


def test_tp_expected_k5_launches():
    """Per rank at 6 layers: 36 a prefill (4 column-parallel linears a
    encoder layer, the cross K/V 2 a decoder layer), 30 a decode step."""
    assert C.tp_expected(6, 1, 0)["w8a8"] == 36 and C.tp_expected(6, 0, 1)["w8a8"] == 30
    assert sum(C.tp_expected(6, 3, 7).values()) == 3 * 36 + 7 * 30


def _broken(phase_runs, how):
    runs = {"gloo x1": copy.deepcopy(phase_runs["one"]),
            "gloo x2": copy.deepcopy(phase_runs["two"])}
    how(runs)
    return runs


@pytest.mark.parametrize("how,match", [
    (lambda r: r["gloo x2"]["ranks"][1]["outs"].__setitem__(0, [5]),
     "rank 1's tokens differ"),
    (lambda r: r["gloo x2"]["ranks"][1]["logits"][0].add_(1.0), "rank 1's logits differ"),
    (lambda r: r["gloo x1"]["outs"].__setitem__(2, r["gloo x1"]["outs"][2] + [7]),
     "1 of 6 requests differ"),
    (lambda r: r["gloo x1"].update(n_done=5), "5 requests back of 6"),
    (lambda r: r["gloo x2"]["logit_diff"][C.TP_GATED_ROWS].__setitem__(1, 4.77e-7),
     "logits differ from one device's at 32 rows"),
    (lambda r: r["gloo x1"]["launches"].update(attn=1), "launched"),
    (lambda r: r["gloo x2"].update(warnings=[]), "fused_attn was dropped"),
    (lambda r: r["gloo x2"].update(kv_bytes=r["gloo x2"]["kv_bytes"] * 2), "KV bytes"),
])
def test_parallel_gates_catch_a_wrong_run(phase_runs, how, match):
    ref = phase_runs["reference"]
    C.check_parallel(_broken(phase_runs, lambda r: None), ref, 1, 9, {"gloo x1"})
    with pytest.raises(AssertionError, match=match):
        C.check_parallel(_broken(phase_runs, how), ref, 1, 9, {"gloo x1"})


def test_a_failing_rank_fails_the_phase_and_leaves_no_child():
    """Three ranks cannot split 8 heads: each rank raises, the launch
    re-raises with the rank's traceback and no spawned process is left."""
    with pytest.raises(Exception, match="divisible by the model axis, 3"):
        P.launch(C.parallel_rank, 3, {**TINY, "device": "cpu", "label": "failing"},
                 timeout_s=300)
    assert multiprocessing.active_children() == []
