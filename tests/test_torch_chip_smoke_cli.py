"""chip_smoke.py's "command lines" phase rehearsed on the CPU
(``tests/chip_smoke_rehearsal.py``'s counting wrappers): the command lines
at 1 + 1 layers, d_model 64, over the IWSLT14 vocabularies, a small corpus (32 valid pairs to
train on in batches of 16, 128 test pairs in one evaluate batch of 128 x
12), the token threshold of the W4A8 prefill at 200 so that its 1,536
tokens take K6/K7 as the card's 9,216 do and a decode step's 128 rows do
not, and the roofline at three small shapes
with the timer stubbed.  The launch gates hold, and a wrong run of each
gate fails the phase."""

import pytest
import torch

import chip_smoke as C
import torch_cli_helpers as H
from chip_smoke_rehearsal import CPU, rehearsal  # noqa: F401  (a fixture)
from onnx_transformer_tpu_torch.evaluation import __main__ as eval_cli
from onnx_transformer_tpu_torch.inject import __main__ as campaign_cli
from onnx_transformer_tpu_torch.models.transformer import TransformerConfig
from onnx_transformer_tpu_torch.ops.kernels import roofline as R
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM
from onnx_transformer_tpu_torch.quant import __main__ as calib_cli
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving import decode as D
from onnx_transformer_tpu_torch.train import __main__ as train_cli

CLI_TINY = dict(valid=32, test=128, batch=16, eval_batch=128, pad=12, samples=2, sentences=2,
                campaign_len=12)
ROOF_TINY = [(64, 64, 96, "a"), (48, 128, 64, "b"), (16, 96, 32, "c")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from H.one_thread()


@pytest.fixture
def cli_rehearsal(rehearsal, monkeypatch):
    for cli in (train_cli, calib_cli, eval_cli, campaign_cli):
        monkeypatch.setattr(cli, "model_config", lambda vs, vt: TransformerConfig(
            len(vs), len(vt), num_layers=1, d_model=64, d_ff=128, num_heads=4))
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 200)
    monkeypatch.setattr(R, "SHAPES", ROOF_TINY)
    monkeypatch.setattr(R, "resolve_device", lambda: CPU)
    monkeypatch.setattr(R, "cuda_ms", lambda fn, **k: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")


def test_cli_phase_launch_counts(cli_rehearsal):
    """pallas: K5 6 + 2 + 8 x 11 and K3 2 x 11 for the one batch of 1 layer
    (K5 alone with K3's plain version in K3's place); int4: K6 3 and K7 2 in
    the prefill; no kernel in train, calibrate, int8 and the campaign; the
    roofline K4 and K5 once a shape (the stubbed timer calls each once)."""
    res = C.run_cli_path(CPU, card="cpu", sizes=CLI_TINY)
    assert C.cli_expected(1, 1, 11, 128 * 12, 200) == {
        "pallas": {"w8a8": 6 + 2 + 8 * 11, "attn": 2 * 11},
        "int4": {"qout4": 3, "q84": 2}, "int8": {},
        "pallas, K3's plain version": {"w8a8": 6 + 2 + 8 * 11}}
    assert res["launches"] == {
        "train": {}, "calibrate": {}, "evaluate pallas": {"w8a8": 96, "attn": 22},
        "evaluate int4": {"qout4": 3, "q84": 2}, "evaluate int8": {},
        "evaluate pallas, K3's plain version": {"w8a8": 96}, "campaign": {},
        "roofline": {"w8a8": 3, "qgemm": 3}}
    assert res["agree"] == res["agree_plain"] == 1.0
    assert [r["shape"] for r in res["roofline"]] == ["64x64x96", "48x128x64", "16x96x32"]


def test_cli_expected_at_the_card_size():
    """The card's runs: one batch of 128 x 72 at 6 + 6 layers, 71 steps,
    the threshold 8,192: K5 3,456 and K3 852 (the serving path's counts),
    K6 18 and K7 12."""
    want = C.cli_expected(6, 1, 71, 128 * 72, TW.FUSED_MIN_TOKENS)
    assert want["pallas"] == {"w8a8": 3456, "attn": 852}
    assert want["pallas, K3's plain version"] == {"w8a8": 3456}
    assert want["int4"] == {"qout4": 18, "q84": 12} and want["int8"] == {}
    assert C.cli_expected(6, 1, 71, 64 * 72, TW.FUSED_MIN_TOKENS)["int4"] == {}


def _no_fused_attn(monkeypatch):
    """The pallas evaluate with K3's attention left out."""
    real = D.greedy_decode
    monkeypatch.setattr(D, "greedy_decode",
                        lambda *a, **k: real(*a, **{**k, "fused_attn": False}))


def _campaign_launches(monkeypatch):
    """A campaign that launches K5 once."""
    real = campaign_cli.main

    def launching(argv):
        x = torch.zeros((1, 4), dtype=torch.int8)
        KM.w8a8_matmul(x, torch.ones(1), torch.zeros((4, 4), dtype=torch.int8), torch.ones(4))
        return real(argv)

    monkeypatch.setattr(campaign_cli, "main", launching)


def _int8_tokens_differ(monkeypatch):
    """An int8 evaluate (no fused_attn) whose every token moves by one."""
    real = D.greedy_decode

    def moved(*a, **k):
        ys = real(*a, **k)
        return ys if k.get("fused_attn") else (ys + 1) % 4

    monkeypatch.setattr(D, "greedy_decode", moved)


def _k3_wrong(monkeypatch):
    """A K3 whose every output is halved: its decode moves far more tokens
    than its plain version's summation order does."""
    from onnx_transformer_tpu_torch.models import transformer as PT

    counted = PT.decode_attention_int8

    def halved(*args, **kwargs):
        return counted(*args, **kwargs) * 0.5

    halved.launches = 0
    monkeypatch.setattr(PT, "decode_attention_int8", halved)


def _roofline_past_the_peak(monkeypatch):
    """A timer that reads a thousandth of the time the peak allows."""
    monkeypatch.setattr(R, "cuda_ms", lambda fn, **k: (fn(), 1e-12)[1])


@pytest.mark.parametrize("wrong,match", [
    (_no_fused_attn, "command line evaluate pallas launched"),
    (_campaign_launches, "command line campaign launched"),
    (_int8_tokens_differ, "evaluate pallas agrees with int8 on"),
    (_k3_wrong, "under K3's plain version's"),
    (_roofline_past_the_peak, "not in \\(0, 1.05\\]"),
], ids=["K3 missing", "campaign launch", "int8 tokens", "K3 wrong", "roofline share"])
def test_cli_phase_catches_a_wrong_run(cli_rehearsal, monkeypatch, wrong, match):
    wrong(monkeypatch)
    with pytest.raises(AssertionError, match=match):
        C.run_cli_path(CPU, card="cpu", sizes=CLI_TINY)
