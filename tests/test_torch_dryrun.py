"""The port's multi-rank dry run (``parallel/dryrun.py``, the JAX package's
``__graft_entry__.dryrun_multichip``) in one gloo world of 8 ranks on the
CPU, at a narrow configuration (vocabularies 97/89, 2 layers, d_model 32,
d_ff 64, 4 heads, dropout 0; the engine at 6 layers of it), with JAX's
weights for each seed (``params_from_jax``):

- it prints its four "OK" lines: dp x tp over (data 4, model 2), dp x pp x
  tp (+SP) over (data 2, pipe 2, model 2), the tensor-parallel engine, the
  campaign split over ``data``;
- the pipelined step's summed KL is within rtol 1e-5 of JAX's
  ``make_pipeline_train_step`` over ``make_pipeline_mesh(2, 2, 2)`` on the
  same weights and batch, and the dp x tp step's of JAX's
  ``make_train_step`` over ``make_mesh(4, 2)``;
- the campaign's rows are one device's.

``jax`` is imported inside the fixtures only: the spawned ranks import this
module to find their function.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import onnx_transformer_tpu_torch as P
from onnx_transformer_tpu_torch.inject import campaign as TC
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.parallel import dryrun as D

CFG = dict(src_vocab_size=97, tgt_vocab_size=89, num_layers=2, d_model=32, d_ff=64,
           num_heads=4, dropout=0.0)
N = 8


def _rank(weights):
    return D.dryrun_multichip(N, cfg=P.TransformerConfig(**CFG), weights=weights,
                              device="cpu")


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from onnx_transformer_tpu.data.dataset import Batch
    from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
    from onnx_transformer_tpu.parallel import pipeline as JPP
    from onnx_transformer_tpu.parallel.mesh import make_mesh
    from onnx_transformer_tpu.train import trainer as JT

    model = Transformer(TransformerConfig(**CFG))
    weights = {seed: model.init(jax.random.key(seed)) for seed in (0, 3)}
    weights[5] = Transformer(TransformerConfig(**{**CFG, "num_layers": 6})).init(
        jax.random.key(5))
    tx = JT.make_optimizer(CFG["d_model"])
    # the dry run's batches: default_rng(1), (8, 12) each, in its order
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(2):
        src = rng.integers(4, CFG["src_vocab_size"], (8, 12)).astype(np.int32)
        tgt = rng.integers(4, CFG["tgt_vocab_size"], (8, 12)).astype(np.int32)
        tgt[:, 0] = 0
        batches.append(JT.batch_to_arrays(Batch.make(src, tgt)))
    mesh = make_mesh(data=4, model=2)
    state = {"params": weights[0], "opt_state": tx.init(weights[0]),
             "step": jnp.zeros((), jnp.int32)}
    _, m = JT.make_train_step(model, tx, mesh=mesh, donate=False)(
        JT.shard_state(state, mesh), JT.shard_batch(batches[0], mesh), jax.random.key(2))
    mesh3 = JPP.make_pipeline_mesh(data=2, pipe=2, model=2)
    stacked = JPP.stack_pipeline_params(weights[3])
    pstate = JPP.shard_pipeline_state({"params": stacked, "opt_state": tx.init(stacked),
                                       "step": jnp.zeros((), jnp.int32)}, mesh3)
    _, pm = JPP.make_pipeline_train_step(model, tx, mesh3, n_micro=2, donate=False)(
        pstate, batches[1], jax.random.key(4))
    return {"weights": {k: jax.tree.map(np.asarray, v) for k, v in weights.items()},
            "dp_tp_loss": float(m["loss"]), "pp_loss": float(pm["loss"]),
            "pp_ntokens": int(pm["ntokens"])}


@pytest.fixture(scope="module")
def dryrun(jax_side):
    return P.launch(_rank, N, jax_side["weights"], timeout_s=600)


def test_dryrun_prints_its_four_ok_lines(dryrun):
    ok = [line for line in dryrun["lines"] if line.endswith(" OK")]
    want = ["dp x tp loss/token", "dp x pp x tp (+sp) loss/token",
            "tp-sharded serving engine 6 layers x 8 slots, 16 requests",
            "mesh campaign 8 result rows"]
    assert len(ok) == 4 and all(line.startswith(f"dryrun_multichip({N}): {w}")
                                for line, w in zip(ok, want))
    assert "mesh: {'data': 2, 'pipe': 2, 'model': 2}" in dryrun["lines"]
    assert dryrun["engine_requests"] == 2 * max(4, 2 * (N // 2))


def test_pipelined_and_dp_tp_losses_match_jax(dryrun, jax_side):
    assert dryrun["pp_loss"] == pytest.approx(jax_side["pp_loss"], rel=1e-5)
    assert dryrun["pp_ntokens"] == jax_side["pp_ntokens"]
    assert dryrun["dp_tp_loss"] == pytest.approx(jax_side["dp_tp_loss"], rel=1e-5)


def test_dryrun_campaign_rows_are_one_devices(dryrun, jax_side):
    """The campaign over (data 4, model 2), one source a data rank, against
    the same campaign on one device."""
    cfg = P.TransformerConfig(**{**CFG, "num_layers": 6})
    model = P.Transformer(cfg)
    params = P.params_from_jax(jax_side["weights"][5], device="cpu")
    sp, lin8 = P.quantize_transformer(model, params, mode="int8")
    src_e = np.random.default_rng(9).integers(4, cfg.src_vocab_size, (16, 12)).astype(np.int32)
    src = torch.from_numpy(src_e[:4])
    specs = [TC.FaultSpec("encoder.layers.0.self_attn.linears.0", "WEIGHT", bit=6),
             TC.FaultSpec("decoder.layers.1.feed_forward.w_1", "INPUT", bit=5, element=2)]
    one = TC.run_campaign(model, sp, lin8.payloads, specs, src, L.make_src_mask(src),
                          [["t1", "t2"]] * 4, D._Vocab(cfg.tgt_vocab_size), max_len=8,
                          fanout=2)
    assert dryrun["campaign_rows"] == one.rows and len(one.rows) == 8


def test_dryrun_command_line_refuses_without_cards():
    """Without ``--platform cpu`` the ranks need a card each."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("cards present: the refusal is for a machine without them")
    proc = subprocess.run([sys.executable, "-m", "onnx_transformer_tpu_torch.parallel.dryrun",
                           "2"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "2 ranks need 2 cards" in proc.stderr


def test_entry_is_the_full_width_forward():
    """``entry()``'s function on its example arguments: the IWSLT14-base
    log-probs of 8 x 16 target positions, each row a distribution."""
    fn, args = D.entry(device="cpu")
    assert args[0]["generator"]["w"].shape == (512, 4444) and len(args[0]["encoder"]["layers"]) == 6
    with torch.no_grad():
        out = fn(*args)
    assert out.shape == (8, 16, 4444) and torch.isfinite(out).all()
    torch.testing.assert_close(out.exp().sum(-1), torch.ones(8, 16), rtol=0, atol=1e-5)
