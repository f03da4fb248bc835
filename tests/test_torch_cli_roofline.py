"""The port's kernel roofline (``python -m
onnx_transformer_tpu_torch.ops.kernels.roofline``) against
``scripts/kernel_roofline.py``: the same six shapes and FLOP counts, peaks
by NVIDIA card name (an unknown name without ``--peak-tops`` exits), and
``bound_ms`` the formula of the card check's kernel rows (K1's 0.045153 ms
at [36864,512]x[512,512], ``PERF.md``).  It refuses to run without a card,
as every command line of the port does without ``--cpu``."""

import pytest
import torch

import torch_cli_helpers as H
from onnx_transformer_tpu_torch.evaluation import __main__ as eval_cli
from onnx_transformer_tpu_torch.inject import __main__ as campaign_cli
from onnx_transformer_tpu_torch.ops.kernels import roofline as R
from onnx_transformer_tpu_torch.quant import __main__ as calib_cli
from onnx_transformer_tpu_torch.train import __main__ as train_cli


def test_shapes_and_flops_equal_the_script(monkeypatch):
    """The script's ``main`` hands its shapes to ``run``; the FLOP count of
    its rows is 2 M K N, as the port's."""
    script = H.load_script("kernel_roofline")
    seen = {}

    def fake_run(shapes, peak):
        seen["shapes"], seen["peak"] = shapes, peak
        return []

    class Device:
        device_kind = "TPU v5 lite"

    monkeypatch.setattr(script, "run", fake_run)
    monkeypatch.setattr(script.jax, "devices", lambda: [Device()])
    monkeypatch.setattr("sys.argv", ["kernel_roofline.py", "--json"])
    script.main()
    assert [tuple(s) for s in R.SHAPES] == [tuple(s) for s in seen["shapes"]]
    row = R.roofline_row(512, 256, 128, "t", pre_ms=1.0, fused_ms=2.0, peak=1e12)
    assert row["prequant_tops"] == pytest.approx(2.0 * 512 * 256 * 128 / 1e-3 / 1e12)
    assert row["fused_quant_roofline"] == pytest.approx(row["prequant_roofline"] / 2)
    keys = {"shape", "tag", "prequant_tops", "prequant_roofline", "fused_quant_tops",
            "fused_quant_roofline"}
    assert keys <= set(row) and row["shape"] == "512x256x128"


def test_peaks_by_card_name():
    assert R.peak_for("NVIDIA H100 80GB HBM3") == 1979e12
    assert R.peak_for("NVIDIA H100 PCIe") == 1513e12
    assert R.peak_for("NVIDIA H100 PCIe", override=5e14) == 5e14
    assert not [k for k in R.PEAK_INT8_BY_KIND if "TPU" in k]
    with pytest.raises(SystemExit, match="pass --peak-tops"):
        R.peak_for("TPU v5 lite")


def test_bounds_are_the_card_checks():
    """K1's row in PERF.md: 0.045153 ms at [36864,512]x[512,512] (f32 out),
    and the roofline rows' bounds at the FFN shape."""
    assert R.bound_ms(36864, 512, 512, 4 * 512)[0] == pytest.approx(0.045153, abs=5e-7)
    row = R.roofline_row(36864, 512, 2048, "ffn w1", 1.0, 1.0, R.INT8_OPS_PER_S)
    assert row["fused_quant_bound_ms"] == R.bound_ms(36864, 512, 2048, 4 * 2048)[0]
    nbytes = 36864 * 512 + 36864 * 4 + 512 * 2048 + 2 * 2048 * 4 + 36864 * 2048 * 4
    assert row["prequant_bound_ms"] == pytest.approx(nbytes / R.HBM_BYTES_PER_S * 1e3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("cli", [eval_cli, calib_cli, campaign_cli, train_cli, R],
                         ids=["evaluation", "quant", "inject", "train", "roofline"])
def test_entry_points_refuse_without_a_card(cli):
    """Without ``--cpu`` each command line asks for the card and there is
    none: no fallback to the CPU.  The roofline has no ``--cpu``."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_roofline_never_times_the_plain_versions():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.run(R.SHAPES[:1], 1979e12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.sweep(1979e12)
