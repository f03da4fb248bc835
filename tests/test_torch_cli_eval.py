"""The port's evaluate, calibrate and campaign command lines
(``python -m onnx_transformer_tpu_torch.{evaluation,quant,inject}``) against
the JAX scripts they port (``scripts/evaluate_iwslt14.py``,
``scripts/calibrate.py``, ``scripts/campaign.py``), both run in-process
under ``--cpu`` at the small configuration of ``tests/torch_cli_helpers.py``
on one seeded corpus and one checkpoint (eight epochs of the port's train
command line; either package reads the other's checkpoints).

- evaluate: fp32 greedy, fp32 beam 2, int8 with ``--scales`` and int4 give
  JAX's ``sentences``, ``bleu_method4`` and ``bleu`` exactly (the decoded
  ids are equal on the CPU) and the same ``--dump`` file; the tail batch is
  dropped as the script drops it; a missing checkpoint raises;
- calibrate: the same keys and shapes as JAX's ``.npz``, values within
  rtol 1e-5 (as ``tests/test_torch_taps.py`` holds ``get_act_scales``);
- campaign: ``--csv-format full`` and ``reference`` write JAX's rows for a
  sweep over INPUT, WEIGHT, INPUT16, WEIGHT16 and RANDOM_BITFLIP, directly
  and through ``--from-json`` on descriptors in the reference's format;
  RANDOM, drawn from a ``torch.Generator``, is held to its properties.  The
  campaign runs at 1 + 1 layers from a checkpoint of its own (eight epochs of
  the port's train command line): the JAX script compiles its golden and
  its batched decode once each, and that compile takes about 36-50 s at 2
  layers on the CPU, 19 s at 1.

Each JAX script runs once per configuration, in module fixtures.
"""

import csv
import json
import os

import numpy as np
import pytest

import torch_cli_helpers as H
from onnx_transformer_tpu_torch.evaluation import __main__ as eval_cli
from onnx_transformer_tpu_torch.inject import __main__ as campaign_cli
from onnx_transformer_tpu_torch.quant import __main__ as calib_cli
from onnx_transformer_tpu_torch.train import __main__ as train_cli

EVAL_ARGS = ["--batch-size", "32", "--max-padding", "12", "--cpu"]
# flag sets of the evaluate runs: fp32 greedy, fp32 beam 2, int8, int4
EVAL_MODES = {"fp32": [], "beam": ["--beam", "2"], "int8": ["--mode", "int8", "--scales"],
              "int4": ["--mode", "int4"]}
FAULT_MODELS = "INPUT,WEIGHT,INPUT16,WEIGHT16,RANDOM_BITFLIP"
CAMPAIGN_ARGS = ["--fault-models", FAULT_MODELS, "--bits", "0,7", "--sentences", "20",
                 "--max-len", "12", "--inject-step", "2", "--fanout", "20", "--cpu"]
# reference descriptors: encoder layer 0's FFN w1 and decoder layer 0's w2
DESCRIPTORS = {"matmul_6.json": {"module": "Encoder/FirstFC", "target_layer": "MatMul_6"},
               "matmul_23.json": {"module": "Decoder/SecondFC", "target_layer": "MatMul_23"}}
CAMPAIGN_LAYERS = 1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from H.one_thread()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus (320 valid, 130 test pairs), the port-trained checkpoint,
    JAX's and the port's calibrated scales."""
    root = tmp_path_factory.mktemp("cli_eval")
    data = H.write_corpus(str(root / "data"), {"valid": 320, "test": 130}, seed=1)
    out = str(root / "ckpt")
    H.run_port(train_cli, ["--data", data, "--out", out, "--epochs", "8", "--batch-size", "16",
                           "--max-padding", "12", "--eval-every", "0", "--warmup", "60",
                           "--base-lr", "0.5", "--cpu"])
    ckpt = os.path.join(out, "model_final.npz")
    calib = ["--data", data, "--ckpt", ckpt, "--num-samples", "3", "--batch-size", "32",
             "--max-padding", "12", "--cpu"]
    scales = {"jax": str(root / "scales_jax.npz"), "port": str(root / "scales_port.npz")}
    printed = {"jax": H.run_script(H.load_script("calibrate"), calib + ["--out", scales["jax"]]),
               "port": H.run_port(calib_cli, calib + ["--out", scales["port"]])}
    return {"root": root, "data": data, "ckpt": ckpt, "scales": scales, "printed": printed}


@pytest.fixture(scope="module")
def evaluations(world):
    """Each mode of EVAL_MODES by the JAX script and by the port: the JSON
    line and the dump file's text."""
    script = H.load_script("evaluate_iwslt14")
    runs = {}
    for key, flags in EVAL_MODES.items():
        flags = flags + ([world["scales"]["jax"]] if key == "int8" else [])
        for side in ("jax", "port"):
            dump = str(world["root"] / f"dump_{key}_{side}.txt")
            argv = ["--data", world["data"], "--ckpt", world["ckpt"], "--dump", dump,
                    *EVAL_ARGS, *flags]
            out = H.run_script(script, argv) if side == "jax" else H.run_port(eval_cli, argv)
            with open(dump) as f:
                runs[key, side] = (H.json_lines(out)[-1], f.read())
    return runs


@pytest.mark.parametrize("mode", list(EVAL_MODES))
def test_evaluate_equals_the_jax_script(evaluations, mode):
    jline, jdump = evaluations[mode, "jax"]
    pline, pdump = evaluations[mode, "port"]
    for key in ("sentences", "bleu_method4", "bleu"):
        assert pline[key] == jline[key], (key, pline, jline)
    assert pline["mode"] == jline["mode"] and pline["beam"] == jline["beam"]
    assert set(pline) == set(jline)
    # 130 pairs in batches of 32: the tail of 2 is dropped, as the script does
    assert pline["sentences"] == 128 and pdump == jdump and len(pdump.splitlines()) == 128


def test_evaluate_learns_something(evaluations):
    """The checkpoint decodes better than chance, so equal BLEUs compare
    real hypotheses."""
    assert evaluations["fp32", "port"][0]["bleu_method4"] > 0.1


def test_evaluate_missing_checkpoint_raises(world, tmp_path):
    with pytest.raises(FileNotFoundError):
        H.run_port(eval_cli, ["--data", world["data"], "--ckpt", str(tmp_path / "absent.npz"),
                              *EVAL_ARGS])


def test_calibrate_equals_the_jax_script(world):
    printed = world["printed"]
    assert printed["port"] == printed["jax"].replace(world["scales"]["jax"],
                                                     world["scales"]["port"])
    with np.load(world["scales"]["jax"]) as zj, np.load(world["scales"]["port"]) as zp:
        assert sorted(zp.files) == sorted(zj.files) and len(zp.files) == 16 * 2
        for k in zj.files:
            assert zp[k].shape == zj[k].shape
            np.testing.assert_allclose(zp[k], zj[k], rtol=1e-5)


def _descriptors(root) -> str:
    folder = root / "descriptors"
    folder.mkdir(exist_ok=True)
    for name, desc in DESCRIPTORS.items():
        (folder / name).write_text(json.dumps(desc))
    return str(folder)


@pytest.fixture(scope="module")
def campaigns(world):
    """The direct sweep (encoder, two targets) and the ``--from-json`` sweep,
    each in both CSV formats, by the JAX script and by the port, at
    ``CAMPAIGN_LAYERS`` with SmoothQuant by scales calibrated on that model:
    the CSV rows and the printed lines."""
    script = H.load_script("campaign")
    out = str(world["root"] / "ckpt_campaign")
    H.run_port(train_cli, ["--data", world["data"], "--out", out, "--epochs", "8",
                           "--batch-size", "16", "--max-padding", "12", "--eval-every", "0",
                           "--warmup", "60", "--base-lr", "0.5", "--cpu"], CAMPAIGN_LAYERS)
    ckpt, scales = os.path.join(out, "model_final.npz"), os.path.join(out, "scales.npz")
    H.run_port(calib_cli, ["--data", world["data"], "--ckpt", ckpt, "--out", scales,
                           "--num-samples", "3", "--batch-size", "32", "--max-padding", "12",
                           "--cpu"], CAMPAIGN_LAYERS)
    base = ["--data", world["data"], "--ckpt", ckpt, "--scales", scales, *CAMPAIGN_ARGS]
    sweeps = {"direct": ["--module", "encoder", "--layers-limit", "2"],
              "from-json": ["--from-json", _descriptors(world["root"])]}
    runs = {}
    for sweep, flags in sweeps.items():
        for fmt in ("full", "reference"):
            for side in ("jax", "port"):
                path = str(world["root"] / f"campaign_{sweep}_{fmt}_{side}.csv")
                argv = base + flags + ["--csv-format", fmt, "--out", path]
                out = (H.run_script(script, argv, CAMPAIGN_LAYERS) if side == "jax"
                       else H.run_port(campaign_cli, argv, CAMPAIGN_LAYERS))
                with open(path) as f:
                    runs[sweep, fmt, side] = (list(csv.reader(f)), out.splitlines())
    return runs


@pytest.mark.parametrize("sweep", ["direct", "from-json"])
@pytest.mark.parametrize("fmt", ["full", "reference"])
def test_campaign_rows_equal_the_jax_script(campaigns, sweep, fmt):
    jrows, jout = campaigns[sweep, fmt, "jax"]
    prows, pout = campaigns[sweep, fmt, "port"]
    # 2 targets x 5 fault models x 2 bits x 20 sentences (+ the header)
    assert len(prows) == 2 * 5 * 2 * 20 + (fmt == "full")
    assert prows == jrows
    # the enumeration's lines, and the summary's count of degraded rows
    assert pout[0] == jout[0] and pout[1] == jout[1]
    assert pout[-1].split(" in ")[0] == jout[-1].split(" in ")[0]
    assert pout[-1].split("); ")[1].split(" -> ")[0] == jout[-1].split("); ")[1].split(" -> ")[0]
    if fmt == "full" and sweep == "direct":
        golden = {r[1] for r in prows[1:]}
        assert any(r[2] != r[1] for r in prows[1:]) and len(golden) > 1


def test_campaign_random_fault_properties(world, tmp_path):
    """RANDOM draws from a ``torch.Generator``, so its rows are held to
    their properties: one experiment per target (bit 0), the golden BLEUs
    of the other sweeps, every BLEU in [0, 1]."""
    path = str(tmp_path / "random.csv")
    out = H.run_port(campaign_cli, ["--data", world["data"], "--ckpt", world["ckpt"],
                                    "--scales", world["scales"]["jax"], "--module", "encoder",
                                    "--layers-limit", "2", "--fault-models", "RANDOM",
                                    "--sentences", "5", "--max-len", "12", "--cpu",
                                    "--out", path])
    assert "2 targets x 1 fault models -> 2 experiments x 5 sentences" in out
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 * 5 and {r["bit"] for r in rows} == {"0"}
    for r in rows:
        assert 0.0 <= float(r["faulty_bleu"]) <= 1.0 and 0.0 <= float(r["golden_bleu"]) <= 1.0
