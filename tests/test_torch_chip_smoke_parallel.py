"""chip_smoke.py's phase "parallel" rehearsed on the CPU at a tiny size
(IWSLT14-base widths, 1 + 1 layers, 4 slots, sources of 9; training at 2 +
2 layers over 4 x 9 pairs, so that the pipelined step splits them into two
stages; the campaign over data=2 on 4 sources of 9, max_len 8): the
one-device reference and a world of one rank in this process (over gloo
here, nccl on the card), then two spawned ranks over gloo, every gate of
``check_parallel`` held, the W4A8 logits, the TP, DP and pipelined train
steps and the campaign among them.  The kernel wrappers are wrapped to
count in this process (the spawned ranks take the plain versions and count
nothing on the CPU, so their launch gate runs on the card only).  Then each
gate on results made wrong on purpose, two training runs made wrong on
purpose in the ranks (a loss normalised by the mean of the data ranks'
means, dropout generators seeded apart across the model group, the timed
step's gradient negated under a mesh, the pipeline's sum of the encoder
memory's cotangent over ``pipe`` left out), K5's and K8's expected launches,
and the ranks' cleanup when they raise."""

import copy
import multiprocessing

import numpy as np
import pytest
import torch
from chip_smoke_rehearsal import install_rehearsal

import chip_smoke as C
import onnx_transformer_tpu_torch as P

CPU = torch.device("cpu")
TINY = dict(layers=1, slots=4, requests=6, seq=9, chunk=3, buckets=(3, 6, 9))
TINY_TRAIN = dict(layers=2, rows=4, seq=9)
TINY_CAMPAIGN = dict(rows=4, seq=9, max_len=8)


@pytest.fixture(scope="module")
def phase_runs():
    """The phase's runs, rehearsed once for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        install_rehearsal(mp)
        return C.run_parallel_path(CPU, card="cpu", sizes=TINY, one_backend="gloo",
                                   timeout_s=300, train=TINY_TRAIN, campaign=TINY_CAMPAIGN)


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


def test_parallel_train_rehearsal(phase_runs):
    """Both ranks' TP and DP steps held to one device's (on the CPU the
    gradients agree to f32 rounding), the collectives of each counted, the
    bf16 step finite, and the W4A8 logits bit-equal to one device's."""
    two = phase_runs["two"]
    assert two["w4a8_logit_diff"] == {rows: [0.0] * C.TP_LOGIT_STEPS for rows in C.TP_LOGIT_ROWS}
    for rank in two["ranks"]:
        train = rank["train"]
        assert train["one"]["ntok"] == train["TP"]["ntok"] == train["DP"]["ntok"] > 0
        for label in ("TP", "DP"):
            got = train[label]
            assert got["loss_rel"] <= 1e-6 and got["grad_share"] <= 1e-5, got
            assert got["step_loss_rel"] <= 1e-6 and got["step_mu_share"] <= 1e-5, got
            assert got["step_mu_same"] == 0.0, got
            assert got["replicated_equal"] and got["gate_flips"] == 0 and got["gates"] > 0
        # TP: the f/g pair's sums; DP: the token count, then one flat sum
        assert {"model_sum", "model_copy"} <= set(train["TP"]["collectives"])
        assert set(train["DP"]["collectives"]) == {"data_sum"}
        assert train["DP"]["collectives"]["data_sum"][0] == 2
        assert np.isfinite(train["bf16"]["loss"]) and train["bf16"]["replicated_equal"]


def test_pipelined_train_and_campaign_rehearsal(phase_runs):
    """Both ranks' pipelined steps (two stages of one layer, 2 microbatches)
    held to one device's, gradients gathered over ``pipe``; per step a rank
    sends or receives each microbatch's activation once a pipeline (the
    encoder's and the decoder's) and its cotangent once back; the campaign
    over data=2 gives one device's rows."""
    for rank in phase_runs["two"]["ranks"]:
        pp = rank["train"]["PP"]
        assert pp["ntok"] == rank["train"]["one"]["ntok"] > 0
        assert pp["loss_rel"] <= 1e-6 and pp["grad_share"] <= 1e-5, pp
        assert pp["step_loss_rel"] <= 1e-6 and pp["step_mu_share"] <= 1e-5, pp
        assert pp["step_mu_same"] == 0.0 and pp["gate_flips"] == 0 and pp["gates"] > 0, pp
        assert pp["replicated_equal"] and pp["launches"] == {}
        assert pp["pipe_sends"] == pp["pipe_recvs"] == 2 * C.PP_MICRO
        assert {"pipe_exchange", "pipe_broadcast", "pipe_sum"} <= set(pp["collectives"])
        camp = rank["campaign"]
        assert camp["rows_equal"] and camp["golden_equal"] and camp["faulty_equal"]
        assert camp["rows"] == 2 * TINY_CAMPAIGN["rows"] and camp["launches"] == {}
        # the INPUT fault addresses the last row, on the second data rank
        assert camp["tokens_changed"][4:7] == [0, 0, 0]


def test_campaign_specs_as_each_data_rank_sees_them():
    """The WEIGHT fault on every rank as it is; the INPUT fault of the last
    source on the second data rank's last row, and on the first rank none."""
    whole = C.campaign_specs(8, 512)
    first, second = C.campaign_specs(8, 512, 0, 2), C.campaign_specs(8, 512, 1, 2)
    assert first[0] == second[0] == whole[0]
    assert whole[1].element == 7 * 512 + 17 and first[1] is None
    assert second[1].element == 3 * 512 + 17
    assert {k: v for k, v in vars(second[1]).items() if k != "element"} == \
        {k: v for k, v in vars(whole[1]).items() if k != "element"}


def _wrong_train_rank(how: str, train: dict) -> list:
    """A rank of a training run made wrong on purpose, every rank's
    ``tp_train`` result gathered: "per-rank mean" normalises each data
    rank's loss by its own token count times the data ranks (the mean of
    the per-rank means, not the KL over the whole batch's count); "drift"
    seeds the dropout generators apart on the ranks of a model group;
    "step sign" negates the gradient of the timed step under a mesh (the
    one without taps or inject), leaving ``value_and_grad``'s as it is;
    "pipe sum" leaves out the pipeline's sum over ``pipe`` of the extras'
    cotangents (the encoder memory's: each stage's decoder layers read
    it)."""
    import torch.distributed as dist

    from onnx_transformer_tpu_torch.train import trainer as T

    if how == "per-rank mean":
        real = T.data_sum

        def per_rank(tensors, mesh):
            if tensors[0].dtype == torch.int32:
                return [t * mesh.data for t in tensors]
            return real(tensors, mesh)

        T.data_sum = per_rank
    elif how == "step sign":
        real = T._local_grads

        def negated(model, *args, **kwargs):
            out, grads = real(model, *args, **kwargs)
            if model.mesh is not None and len(args) == 6:
                grads = [-g for g in grads]
            return out, grads

        T._local_grads = negated
    elif how == "pipe sum":
        from onnx_transformer_tpu_torch.parallel import pipeline as PP

        PP.pipe_sum = lambda tensors, mesh: list(tensors)
        result, ref = C.tp_train(CPU, train)
        result["PP"] = C.pp_train(**ref)
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, result)
        return everyone
    else:
        P.mesh_generator = lambda seed, mesh, device=None: torch.Generator(
            device=mesh.device).manual_seed(seed + dist.get_rank())
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, C.tp_train(CPU, train)[0])
    return everyone


@pytest.mark.parametrize("how,match", [("per-rank mean", "parallel train DP"),
                                       ("drift", "parallel train bf16"),
                                       ("step sign", "parallel train TP rank 0: the timed step"),
                                       ("pipe sum", "parallel train PP rank 0: loss")])
def test_parallel_train_gates_catch_a_wrong_run(how, match):
    # a pipelined step needs an even depth; the others train one layer
    train = TINY_TRAIN if how == "pipe sum" else {**TINY_TRAIN, "layers": 1}
    ranks = P.launch(_wrong_train_rank, 2, how, train, timeout_s=300)
    with pytest.raises(AssertionError, match=match):
        C.check_parallel_train(ranks)


def test_tp_expected_k5_launches():
    """Per rank at 6 layers: 36 a prefill (4 column-parallel linears a
    encoder layer, the cross K/V 2 a decoder layer), 30 a decode step."""
    assert C.tp_expected(6, 1, 0)["w8a8"] == 36 and C.tp_expected(6, 0, 1)["w8a8"] == 30
    assert sum(C.tp_expected(6, 3, 7).values()) == 3 * 36 + 7 * 30


def test_tp_w4a8_expected_k8_launches():
    """Per rank at 2 layers and 3 steps, for each of the 2 batches: 12 a
    prefill (4 column-parallel linears a encoder layer, the cross K/V 2 a
    decoder layer), 10 a decode step; no other kernel."""
    want = C.tp_w4a8_expected(2, 3)
    assert want["qgemm4"] == 2 * (12 + 3 * 10) and sum(want.values()) == want["qgemm4"]


def test_parallel_gates_count_the_w4a8_launches_where_counted(phase_runs):
    """With the two-rank run counted (as on the card), each rank's W4A8
    logits must launch ``tp_w4a8_expected``'s K8 and nothing else."""
    ref = phase_runs["reference"]

    def as_on_the_card(r, k8=None):
        two = r["gloo x2"]
        for rank in two["ranks"]:
            rank["launches"] = C.tp_expected(1, two["prefills"], two["steps"])
            rank["w4a8_launches"] = C.tp_w4a8_expected(1)
        if k8 is not None:
            two["ranks"][1]["w4a8_launches"]["qgemm4"] = k8

    C.check_parallel(_broken(phase_runs, as_on_the_card), ref, 1, 9, {"gloo x1", "gloo x2"})
    for k8 in (0, C.tp_w4a8_expected(1)["qgemm4"] - 1):
        with pytest.raises(AssertionError, match="rank 1's W4A8 logits launched"):
            C.check_parallel(_broken(phase_runs, lambda r: as_on_the_card(r, k8)), ref, 1, 9,
                             {"gloo x1", "gloo x2"})


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
    (lambda r: r["gloo x2"]["w4a8_logit_diff"][C.TP_GATED_ROWS].__setitem__(2, 4.77e-7),
     "W4A8 logits differ from one device's at 32 rows"),
    (lambda r: r["gloo x2"]["ranks"][1]["train"]["DP"].update(replicated_equal=False),
     "replicated leaves differ"),
    (lambda r: r["gloo x2"]["ranks"][0]["train"]["TP"].update(gate_flips=10 ** 6),
     "ReLU gates flipped"),
    (lambda r: r["gloo x2"]["ranks"][1]["train"]["DP"].update(step_loss_rel=2e-5),
     "the timed step's loss"),
    (lambda r: r["gloo x2"]["ranks"][0]["train"]["TP"].update(step_mu_share=2e-3),
     "the timed step's loss"),
    (lambda r: r["gloo x2"]["ranks"][0]["train"]["DP"].update(step_mu_same=1e-5),
     "unsnapped gradient"),
    (lambda r: r["gloo x2"]["ranks"][1]["train"]["PP"].update(replicated_equal=False),
     "parallel train PP rank 1: the replicated leaves differ"),
    (lambda r: r["gloo x2"]["ranks"][0]["train"].pop("PP"), "ran no pipelined train step"),
    (lambda r: r["gloo x2"]["ranks"][0]["train"]["PP"].update(launches={"w8a8": 1}),
     "parallel train PP rank 0: the step launched"),
    (lambda r: r["gloo x2"]["ranks"][1]["train"]["PP"].update(grad_share=2e-4),
     "parallel train PP rank 1: loss"),
    (lambda r: r["gloo x2"]["ranks"][1]["campaign"].update(faulty_equal=False),
     "parallel campaign rank 1"),
    (lambda r: r["gloo x2"]["ranks"][0]["campaign"].update(rows=7), "parallel campaign rank 0"),
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
