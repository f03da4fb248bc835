"""The port's train command line (``python -m onnx_transformer_tpu_torch.train``)
against ``scripts/train_iwslt14.py``, both run in-process under ``--cpu`` at
the small configuration of ``tests/torch_cli_helpers.py`` with dropout 0, on
one seeded corpus (160 valid pairs to train on, 128 test pairs, the least
that the script's BLEU decodes), both resuming (``--resume``) from one
checkpoint: the JAX init, written by JAX's ``CKPT``.

- each epoch line's ``loss_per_token`` within 1e-4 absolute (it is printed
  to four places), the test BLEUs equal (the ids are equal), the other
  printed lines the same;
- ``model_final.npz``: every parameter within ``_assert_state_close``'s
  bound (``tests/test_torch_train_step.py``: 1e-4 of each leaf's largest
  value, the k-projection biases within 2 x the sum of the learning rates),
  the counts and the step equal; ``params_final.npz`` the same params;

and the port alone:

- ``--qat w4a8`` with ``--token-budget`` runs and lowers the loss;
- ``--pipeline 2`` (two gloo ranks, 2 microbatches) gives the one-process
  run's epoch lines and checkpoint within the same bounds;
- ``--num-processes 2`` (two spawned processes over a ``file://``
  rendezvous, each loading its shard) gives one process's run over the
  concatenated shards' batches (the global batch), within the same bounds,
  and only process 0 prints and saves;
- ``--pipeline`` with ``--num-processes 2`` is refused.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import torch_cli_helpers as H
from onnx_transformer_tpu_torch.data.dataset import BucketedLoader, load_split
from onnx_transformer_tpu_torch.models.transformer import Transformer
from onnx_transformer_tpu_torch.params import tree_paths
from onnx_transformer_tpu_torch.train import __main__ as train_cli
from onnx_transformer_tpu_torch.train import checkpoint as CK
from onnx_transformer_tpu_torch.train import trainer as T
from onnx_transformer_tpu_torch.train.schedule import noam_schedule

EPOCHS, BATCH, PAD, LR, WARMUP = 2, 16, 12, 0.5, 60
ARGS = ["--epochs", str(EPOCHS), "--batch-size", str(BATCH), "--max-padding", str(PAD),
        "--eval-every", "1", "--base-lr", str(LR), "--warmup", str(WARMUP), "--cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from H.one_thread()


def _start(root, name: str, init: str) -> str:
    """An output folder holding the initial checkpoint, to resume from."""
    out = os.path.join(root, name)
    os.makedirs(out)
    for suffix in ("", ".meta.json"):
        shutil.copy(init + suffix, os.path.join(out, "model_final.npz" + suffix))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX script's and the port's runs from the JAX init: printed
    lines and output folders."""
    import jax

    from onnx_transformer_tpu import Transformer as JTransformer
    from onnx_transformer_tpu import TransformerConfig as JConfig
    from onnx_transformer_tpu.train import checkpoint as JCK
    from onnx_transformer_tpu.train import trainer as JT

    root = str(tmp_path_factory.mktemp("cli_train"))
    data = H.write_corpus(os.path.join(root, "data"), {"valid": 160, "test": 128}, seed=2)
    vs, vt = H.jax_vocabs()
    cfg = JConfig(len(vs), len(vt), scan_layers=True, **H.SMALL)
    tx = JT.make_optimizer(cfg.d_model, base_lr=LR, warmup=WARMUP)
    init = os.path.join(root, "init.npz")
    # epoch -1: the resumed runs start at epoch 0
    JCK.save_params_with_meta(init, JT.init_state(JTransformer(cfg), tx,
                                                  jax.random.key(3)).tree(), {"epoch": -1})
    out = {side: _start(root, side, init) for side in ("jax", "port")}
    argv = ["--data", data, "--resume", *ARGS]
    printed = {"jax": H.run_script(H.load_script("train_iwslt14"), argv + ["--out", out["jax"]]),
               "port": H.run_port(train_cli, argv + ["--out", out["port"]])}
    return {"root": root, "data": data, "init": init, "out": out, "printed": printed}


def _steps() -> int:
    return EPOCHS * (160 // BATCH)


def _lr_sum(steps: int) -> float:
    sched = noam_schedule(H.SMALL["d_model"], LR, WARMUP)
    return sum(float(sched(torch.tensor(i))) for i in range(steps))


def _flat(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_params_close(got: dict, want: dict, lr_sum: float, prefix: str = "params/"):
    """``_assert_state_close``'s bound over two flat checkpoints."""
    keys = [k for k in want if k.startswith(prefix)]
    assert keys and sorted(k for k in got if k.startswith(prefix)) == sorted(keys)
    for key in keys:
        d = np.abs(got[key] - want[key]).max()
        if key.endswith("/k/b"):
            assert d <= 2 * lr_sum, (key, d, lr_sum)
        else:
            assert d <= 1e-4 * np.abs(want[key]).max(), (key, d)


def _assert_lines_close(got: list, want: list):
    assert len(got) == len(want) == EPOCHS + 1
    for g, w in zip(got[:-1], want[:-1]):
        assert g["epoch"] == w["epoch"] and set(g) == set(w)
        assert abs(g["loss_per_token"] - w["loss_per_token"]) <= 1e-4, (g, w)


def test_train_equals_the_jax_script(runs):
    jout, pout = runs["printed"]["jax"].splitlines(), runs["printed"]["port"].splitlines()
    # devices differ by name; the corpus line and the resume line are the script's
    assert jout[0].startswith("devices:") and pout[0].startswith("devices:")
    assert pout[1:3] == jout[1:3] == [
        "train pairs 160, test pairs 128, vocab 43/33", "resumed from epoch 0"]
    jl, pl = H.json_lines(runs["printed"]["jax"]), H.json_lines(runs["printed"]["port"])
    _assert_lines_close(pl, jl)
    # the ids are equal, so are the BLEUs
    assert [x.get("test_bleu") for x in pl] == [x.get("test_bleu") for x in jl]
    assert pl[-1] == jl[-1] and set(pl[-1]) == {"final_test_bleu"}
    assert pl[-2]["loss_per_token"] < pl[0]["loss_per_token"]


def test_train_checkpoints_equal_the_jax_script(runs):
    lr_sum = _lr_sum(_steps())
    got = _flat(os.path.join(runs["out"]["port"], "model_final.npz"))
    want = _flat(os.path.join(runs["out"]["jax"], "model_final.npz"))
    assert sorted(got) == sorted(want)
    _assert_params_close(got, want, lr_sum)
    for key in ("step", "opt_state/0/.count", "opt_state/1/.count"):
        assert int(got[key]) == int(want[key]) == _steps()
    final_p = _flat(os.path.join(runs["out"]["port"], "params_final.npz"))
    final_j = _flat(os.path.join(runs["out"]["jax"], "params_final.npz"))
    _assert_params_close(final_p, final_j, lr_sum, prefix="")
    for side in ("jax", "port"):
        meta = CK.load_meta(os.path.join(runs["out"][side], "model_final.npz"))
        assert meta == {"epoch": EPOCHS - 1, "config": "iwslt14-base"}


def test_qat_with_a_token_budget_learns(runs, tmp_path):
    out = H.run_port(train_cli, ["--data", runs["data"], "--out", str(tmp_path), "--qat",
                                 "w4a8", "--token-budget", "160", "--epochs", "3",
                                 "--batch-size", str(BATCH), "--max-padding", str(PAD),
                                 "--eval-every", "0", "--base-lr", "1", "--warmup", "20",
                                 "--cpu"])
    lines = H.json_lines(out)
    assert len(lines) == 4 and np.isfinite([x["loss_per_token"] for x in lines[:-1]]).all()
    assert lines[2]["loss_per_token"] < lines[0]["loss_per_token"]
    assert os.path.exists(tmp_path / "params_final.npz")


def test_pipeline_gives_one_process(runs, capfd, monkeypatch):
    """Two gloo ranks, 2 microbatches of 8: the epoch lines and the
    checkpoint of the one-process run (``runs``) within its bounds."""
    out = _start(runs["root"], "pipeline", runs["init"])
    monkeypatch.setattr(train_cli, "model_config", H.port_config)
    vocabs = H.port_vocabs()
    monkeypatch.setattr(train_cli, "load_iwslt14_vocab", lambda: vocabs)
    assert train_cli.main(["--data", runs["data"], "--out", out, "--resume", "--pipeline",
                           "2", "--pipeline-micro", "2", *ARGS]) == 0
    printed = capfd.readouterr().out
    assert "pipeline mesh: {'data': 1, 'pipe': 2, 'model': 1}" in printed
    assert printed.count("resumed from epoch 0") == 1
    _assert_lines_close(H.json_lines(printed), H.json_lines(runs["printed"]["port"]))
    got = _flat(os.path.join(out, "model_final.npz"))
    want = _flat(os.path.join(runs["out"]["port"], "model_final.npz"))
    assert sorted(got) == sorted(want)
    _assert_params_close(got, want, _lr_sum(_steps()))
    assert int(got["step"]) == _steps()


def _one_process_on_the_global_batches(runs) -> tuple[list, dict]:
    """The port's train step in one process over each step's two shards
    concatenated (process 0's rows first): the epochs' loss per token and
    the final params."""
    vs, vt = H.port_vocabs()
    model = Transformer(H.port_config(vs, vt))
    tx = T.make_optimizer(H.SMALL["d_model"], base_lr=LR, warmup=WARMUP)
    state = CK.restore(runs["init"], T.init_state(model, tx, device="cpu").tree())
    step = T.make_train_step(model, tx)
    pairs = load_split(runs["data"], "valid")
    loaders = [BucketedLoader(pairs, vs, vt, batch_size=BATCH, max_padding=PAD, seed=7,
                              num_shards=2, shard_index=r) for r in (0, 1)]
    losses = []
    for epoch in range(EPOCHS):
        tot = tok = 0.0
        for loader in loaders:
            loader.set_epoch(epoch)
        for b0, b1 in zip(*loaders):
            a0, a1 = (T.batch_to_arrays(b, device="cpu") for b in (b0, b1))
            state, m = step(state, tuple(torch.cat(pair) for pair in zip(a0, a1)), None)
            tot, tok = tot + float(m["loss"]), tok + float(m["ntokens"])
        losses.append(tot / tok)
    return losses, {"params/" + k: v.numpy() for k, v in tree_paths(state["params"])}


def test_num_processes_gives_one_process_on_the_global_batch(runs, tmp_path):
    import torch.multiprocessing as mp

    out = _start(str(tmp_path), "multi", runs["init"])
    argv = ["--data", runs["data"], "--out", out, "--resume", *ARGS, "--coordinator",
            f"file://{tmp_path}/rendezvous", "--num-processes", "2"]
    mp.start_processes(H.cli_rank, args=("onnx_transformer_tpu_torch.train.__main__", argv,
                                         str(tmp_path)), nprocs=2, start_method="spawn")
    printed = [(tmp_path / f"rank{r}.txt").read_text() for r in (0, 1)]
    lines = H.json_lines(printed[0])
    assert len(lines) == EPOCHS + 1 and not H.json_lines(printed[1])
    losses, params = _one_process_on_the_global_batches(runs)
    for line, want in zip(lines, losses):
        assert abs(line["loss_per_token"] - want) <= 1e-4, (line, want)
    got = _flat(os.path.join(out, "model_final.npz"))
    # 160 pairs in two shards of 80: 5 global steps of 2 x 16 rows an epoch
    steps = EPOCHS * (160 // (2 * BATCH))
    assert int(got["step"]) == steps
    _assert_params_close(got, params, _lr_sum(steps))


def test_pipeline_with_several_processes_is_refused(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--pipeline", "2", "--num-processes", "2", "--cpu"])
    assert "not with --num-processes" in capsys.readouterr().err
