"""Pipeline parallelism (``parallel/pipeline.py``: GPipe over a ``pipe``
axis, sequence parallelism, the DP x PP x TP train step) and the campaign
over a data mesh (``run_campaign(..., mesh=)``) against the JAX package,
on the CPU.

One gloo world of 4 ranks (``parallel.launch``) computes every case once
in a module-scoped fixture; JAX runs here over its 8 virtual devices
(``conftest.py``), from the same weights (``params_from_jax``), at
``tests/test_pipeline.py``'s configuration (vocabularies 97/89, 4 layers,
d_model 32, d_ff 64, 4 heads, dropout 0, B=8, S=10; 2 microbatches), over
the (data, pipe, model) meshes (1, 2, 2), (2, 2, 1) and (1, 4, 1):

- the toy ``pipeline_apply`` (``test_pipeline.py:38-53``) against the
  sequential stack, within rtol 1e-6;
- ``pipelined_forward_logits`` against JAX's over the same mesh within
  atol 2e-5, and against the port's one-device ``forward_logits``;
- the gradients of every leaf (each rank's stage gathered over ``pipe`` and
  ``model``) against ``jax.grad`` of JAX's plain loss within atol 1e-5 (the
  embeddings, the encoder layers, whose gradient comes through the memory,
  the final norms, the generator): at pipe = 4 a cotangent counted ``pipe``
  times, or not summed, is off by a factor of 4;
- ``make_pipeline_train_step``'s step against the port's one-device step
  and JAX's plain ``make_train_step`` with ``test_torch_train_mesh.py``'s
  bounds (loss rtol 1e-5, Adam's first moment rtol 1e-4 / atol 1e-7,
  parameters 1.1e-3), the replicated leaves bit-equal on every rank;
- the pipe collectives of one forward and backward: a send and a receive
  per microbatch per stage boundary, each way, for each of the two
  pipelines;
- three dropout-0.3 steps on (2, 2, 1), after which the replicated leaves
  are bit-equal on every rank;
- ``sp_constrain`` at model = 2: the logits and gradients within 1e-6 of
  the same run with sequence parallelism off, at S=10 and at S=9 (which 2
  does not divide), and at dropout 0.3 (the masks of the whole sequence);
- ``run_campaign`` over ``make_mesh(data=2, model=2)`` at
  ``tests/test_torch_inject.py``'s configuration: rows, tokens and CSV
  bytes equal to one device's, and to JAX's campaign on the same sources
  (RANDOM draws from a ``torch.Generator``, so it is held to one device's
  only).

Without ranks: the stacking against JAX's, the spec trees, and the
refusals.  ``jax`` is imported inside the fixtures and tests only: the
spawned ranks import this module to find their function.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

import onnx_transformer_tpu_torch as P
from onnx_transformer_tpu_torch.data.dataset import Batch
from onnx_transformer_tpu_torch.inject import campaign as TC
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.parallel import collectives as PC
from onnx_transformer_tpu_torch.parallel import pipeline as PP
from onnx_transformer_tpu_torch.params import tree_leaves, tree_unflatten
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.train import trainer as T

CFG = dict(src_vocab_size=97, tgt_vocab_size=89, num_layers=4, d_model=32, d_ff=64,
           num_heads=4, dropout=0.0)
LR = dict(base_lr=2.0, warmup=100)
MESHES = {"1x2x2": (1, 2, 2), "2x2x1": (2, 2, 1), "1x4x1": (1, 4, 1)}
N_MICRO = 2
DROPOUT_STEPS = 3
# the campaign (tests/test_torch_inject.py's qmodel: vocabularies 37/31, 2
# layers, weights from jax.random.key(21)) on 4 sources of 8, max_len 10;
# the element-addressed faults sit in the second data rank's rows
QCFG = dict(src_vocab_size=37, tgt_vocab_size=31, num_layers=2, d_model=32, d_ff=64,
            num_heads=4, dropout=0.0)
CAMPAIGN_MAX_LEN = 10
CAMPAIGN_SPECS = [
    ("encoder.layers.0.self_attn.linears.0", "WEIGHT", dict(bit=7, element=5)),
    ("encoder.layers.1.feed_forward.w_2", "INPUT", dict(bit=7, element=3 * 8 * 64 + 11)),
    ("encoder.layers.1.feed_forward.w_2", "INPUT16", dict(bit=7, row=3 * 8 + 2)),
    ("encoder.layers.1.self_attn.linears.2", "INPUT16", dict(bit=7, row=3 * 8 + 2)),
    ("encoder.layers.1.feed_forward.w_2", "RANDOM_BITFLIP", dict(bit=30, element=3 * 8 * 32 + 5)),
    ("decoder.layers.1.feed_forward.w_2", "RANDOM_BITFLIP", dict(bit=30, element=3 * 32 + 5,
                                                                 inject_step=1)),
    ("decoder.layers.1.feed_forward.w_1", "INPUT", dict(bit=6, element=3 * 32 + 7,
                                                        inject_step=2)),
    ("encoder.layers.1.self_attn.qk_matmul", "RANDOM_BITFLIP",
     dict(bit=30, element=3 * 4 * 8 * 8 + 9)),
    ("decoder.layers.0.src_attn.av_matmul", "INPUT", dict(bit=6, element=2 * 4 * 8 + 3,
                                                          inject_step=1)),
]
RANDOM_SPECS = [("encoder.layers.1.feed_forward.w_1", "RANDOM", dict(seed=3)),
                ("decoder.layers.0.self_attn.linears.0", "RANDOM", dict(seed=11,
                                                                       inject_step=1))]


class _Vocab:
    itos = ["<s>", "</s>", "<blank>", "<unk>"] + [f"t{i}" for i in range(27)]


def _batch_arrays(s=10, seed=0):
    """src, tgt of ``tests/test_pipeline.py``'s fixture (B=8)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 97, (8, s)).astype(np.int32)
    src[:, -2:] = 2
    tgt = rng.integers(4, 89, (8, s)).astype(np.int32)
    tgt[:, 0] = 0
    return src, tgt


def _campaign_sources():
    src = np.random.default_rng(3).integers(4, 37, (4, 8)).astype(np.int32)
    src[1, 6:] = 2
    return src


def _specs(C, entries):
    return [C.FaultSpec(t, fm, **kw) for t, fm, kw in entries]


def _np(tree) -> list:
    return [t.detach().float().numpy().copy() for t in tree_leaves(tree)]


def _same_on_every_rank(t: torch.Tensor) -> bool:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)


def _state(params, tx):
    return {"params": params, "opt_state": tx.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _whole(local, mesh) -> list:
    """A stacked tree of this rank's slices -> one device's leaves."""
    return _np(PP.unstack_pipeline_params(PP.gather_pipeline_params(local, mesh)))


def _toy(mesh) -> np.ndarray:
    """``test_pipeline.py``'s toy pipeline (4 layers h @ (i + 1) I + c,
    4 microbatches), this rank's stage and rows, the rows gathered."""
    lp = {"w": torch.stack([torch.eye(4) * (i + 1) for i in range(4)])}
    lp = {"w": lp["w"].chunk(mesh.pipe)[mesh.pipe_rank]}
    x = P.parallel.local_rows(torch.arange(8 * 3 * 4, dtype=torch.float32).reshape(8, 3, 4),
                              mesh)

    def layer_fn(lp, h, ex, gen):
        return h @ lp["w"] + ex["c"]

    out = PP.pipeline_apply(layer_fn, lp, x, {"c": torch.ones_like(x)}, n_micro=4, mesh=mesh)
    return P.parallel.gather_rows(out, mesh).numpy()


def _grads(model, params, rows, mesh, rng=None):
    """The loss, logits and this rank's gradients of the pipelined forward."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    logits = PP.pipelined_forward_logits(model, tree_unflatten(params, leaves), rows[0], rows[1],
                                         rows[3], rows[4], mesh=mesh, n_micro=N_MICRO, rng=rng,
                                         train=True, log_probs=False)
    mean, loss, _ = T.token_loss(logits, rows[2], 2, 0.1, mesh)
    grads = torch.autograd.grad(mean, leaves)
    return float(loss), logits.detach(), tree_unflatten(params, list(grads))


@contextlib.contextmanager
def _sequence_parallel_off():
    """The pipelined forward with its regions (embeddings, final norms) run
    whole on every rank: ``sp_constrain`` the region on the whole sequence,
    the replicated parameters entering without ``model_copy``."""
    constrain, replicated = PP.sp_constrain, PP._replicated
    PP.sp_constrain = lambda x, mesh, region=None: x if region is None else region(x, 0)
    PP._replicated = lambda p, mesh: p
    try:
        yield
    finally:
        PP.sp_constrain, PP._replicated = constrain, replicated


def _sp_case(model, params, arrs, mesh, seed=None) -> dict:
    """SP on against SP off: the logits' and the gradients' largest
    difference (each with the same dropout generator seed, where given)."""
    stacked = PP.stack_pipeline_params(params)
    st = PP.shard_pipeline_state(_state(stacked, P.make_optimizer(32)), mesh)
    rows = T.shard_batch(arrs, mesh)
    runs = []
    for sp in (True, False):
        gen = None if seed is None else P.mesh_generator(seed, mesh)
        PC.reset_counts()
        with contextlib.nullcontext() if sp else _sequence_parallel_off():
            loss, logits, g = _grads(model, st["params"], rows, mesh, gen)
        runs.append((loss, logits, _whole(g, mesh), PC.seq_gather.calls))
    (l1, z1, g1, n1), (l2, z2, g2, n2) = runs
    return {"loss": (l1, l2), "logits": (z1 - z2).abs().max().item(),
            "grads": max(np.abs(a - b).max() for a, b in zip(g1, g2)),
            "gmax": max(np.abs(a).max() for a in g2), "seq_gathers": (n1, n2)}


def _mesh_case(model, tx, params, arrs, mesh) -> dict:
    out = {"toy": _toy(mesh)}
    stacked = PP.stack_pipeline_params(params)
    st = PP.shard_pipeline_state(_state(stacked, tx), mesh)
    rows = T.shard_batch(arrs, mesh)
    with torch.no_grad():
        logp = PP.pipelined_forward_logits(model, st["params"], rows[0], rows[1], rows[3],
                                           rows[4], mesh=mesh, n_micro=N_MICRO)
    out["logits"] = P.parallel.gather_rows(logp, mesh).numpy()
    PC.reset_counts()
    (mean, loss, ntok), g = PP.pipeline_value_and_grad(model, st["params"], rows, mesh=mesh,
                                                       n_micro=N_MICRO)
    counts = (mesh.pipe_rank, PC.pipe_exchange.sends, PC.pipe_exchange.recvs)
    out["counts"] = [None] * dist.get_world_size()
    dist.all_gather_object(out["counts"], counts)
    out["grads"] = _whole(tree_unflatten(st["params"], g), mesh)
    out["mean"] = float(mean)
    step = PP.make_pipeline_train_step(model, tx, mesh, n_micro=N_MICRO, donate=False)
    new, m = step(st, rows, None)
    out.update(loss=float(m["loss"]), ntok=int(m["ntokens"]),
               params=_whole(new["params"], mesh), mu=_whole(new["opt_state"][0].mu, mesh),
               counts_after=(int(new["opt_state"][0].count), int(new["step"])),
               replicated_equal=_same_on_every_rank(_replicated(new["params"])))
    return out


def _replicated(params) -> torch.Tensor:
    """The embeddings, final norms and generator of a stage's params, flat."""
    whole = [params["src_embed"], params["tgt_embed"], params["encoder"]["ln"],
             params["decoder"]["ln"], params["generator"]]
    return torch.cat([t.reshape(-1) for t in tree_leaves(whole)])


def _campaign(q_params, csv_dir) -> dict:
    """The campaign over make_mesh(data=2, model=2) on every rank."""
    model = P.Transformer(P.TransformerConfig(**QCFG))
    params = P.params_from_jax(q_params, device="cpu")
    payloads = TW.quantize_model_params(model, params, 8)
    mesh = P.make_mesh(data=2, model=2, device="cpu")
    src = torch.from_numpy(_campaign_sources())
    sm = L.make_src_mask(src)
    out = {}
    for name, entries in (("specs", CAMPAIGN_SPECS), ("random", RANDOM_SPECS)):
        res = TC.run_campaign(model, params, payloads, _specs(TC, entries), src, sm,
                              [["t1", "t2", "t3"]] * 4, _Vocab, max_len=CAMPAIGN_MAX_LEN,
                              csv_path=f"{csv_dir}/{name}.csv", fanout=4, mesh=mesh)
        out[name] = {"rows": res.rows, "golden": res.golden,
                     "faulty": [np.asarray(f) for f in res.faulty]}
    return out


def _world(np_params, q_params, csv_dir):
    """Every case, on each of 4 ranks; rank 0's dict is returned."""
    cfg = P.TransformerConfig(**CFG)
    model = P.Transformer(cfg)
    tx = P.make_optimizer(32, **LR)
    params = P.params_from_jax(np_params, device="cpu")
    arrs = T.batch_to_arrays(Batch.make(*_batch_arrays()), device="cpu")
    (mean, _, _), g = T.value_and_grad(model, params, arrs)
    new, m = P.make_train_step(model, tx, donate=False)(_state(params, tx), arrs, None)
    with torch.no_grad():
        logits = model.forward_logits(params, arrs[0], arrs[1], arrs[3], arrs[4])
    out = {"one": {"mean": float(mean), "grads": [x.numpy() for x in g], "loss": float(m["loss"]),
                   "ntok": int(m["ntokens"]), "params": _np(new["params"]),
                   "mu": _np(new["opt_state"][0].mu), "logits": logits.numpy()}}
    meshes = {name: PP.make_pipeline_mesh(*dims, device="cpu") for name, dims in MESHES.items()}
    for name, mesh in meshes.items():
        out[name] = _mesh_case(model, tx, params, arrs, mesh)

    # dropout 0.3 over (2, 2, 1): three steps
    mesh = meshes["2x2x1"]
    dmodel = P.Transformer(cfg.with_(dropout=0.3))
    stacked = PP.stack_pipeline_params(params)
    st = PP.shard_pipeline_state(_state(stacked, tx), mesh)
    rows = T.shard_batch(arrs, mesh)
    step = PP.make_pipeline_train_step(dmodel, tx, mesh, n_micro=N_MICRO, donate=False)
    gen = P.mesh_generator(7, mesh)
    losses = []
    for _ in range(DROPOUT_STEPS):
        st, m = step(st, rows, gen)
        losses.append(float(m["loss"]))
    out["dropout"] = {"losses": losses,
                      "replicated_equal": _same_on_every_rank(_replicated(st["params"]))}

    # sequence parallelism at model = 2
    mesh = meshes["1x2x2"]
    arrs9 = T.batch_to_arrays(Batch.make(*_batch_arrays(s=9, seed=4)), device="cpu")
    out["sp"] = {"S10": _sp_case(model, params, arrs, mesh),
                 "S9": _sp_case(model, params, arrs9, mesh),
                 "S9 dropout": _sp_case(dmodel, params, arrs9, mesh, seed=5)}
    out["campaign"] = _campaign(q_params, csv_dir)
    return out


# ------------------------------------------------------------------ JAX side

@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from onnx_transformer_tpu.data.dataset import Batch as JBatch
    from onnx_transformer_tpu.evaluation import bleu as JBLEU
    from onnx_transformer_tpu.inject import campaign as JC
    from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
    from onnx_transformer_tpu.ops import layers as JL
    from onnx_transformer_tpu.parallel import pipeline as JPP
    from onnx_transformer_tpu.quant import w8a8 as JW
    from onnx_transformer_tpu.serving.decode import ids_to_tokens as jax_ids_to_tokens
    from onnx_transformer_tpu.train import trainer as JT
    from onnx_transformer_tpu.train.loss import loss_and_ntokens

    model = Transformer(TransformerConfig(**CFG))
    params = model.init(jax.random.key(0))
    b = JBatch.make(*_batch_arrays())
    arrs = JT.batch_to_arrays(b)
    out = {"np_params": jax.tree.map(np.asarray, params)}
    for name, dims in MESHES.items():
        mesh = JPP.make_pipeline_mesh(*dims, devices=jax.devices()[:4])
        out[name] = np.asarray(jax.jit(lambda p, mesh=mesh: JPP.pipelined_forward_logits(
            model, p, b.src, b.tgt_in, b.src_mask, b.tgt_mask, mesh=mesh, n_micro=N_MICRO))(
                JPP.stack_pipeline_params(params)))

    def plain_loss(p):
        logp = model.forward_logits(p, arrs[0], arrs[1], arrs[3], arrs[4])
        loss, n = loss_and_ntokens(logp, arrs[2], model.cfg.pad_id, 0.1)
        return loss / jnp.maximum(n, 1)

    out["grads"] = [np.asarray(x) for x in jax.tree.leaves(jax.jit(jax.grad(plain_loss))(params))]
    tx = JT.make_optimizer(32, **LR)
    state = JT.init_state(model, tx, jax.random.key(0)).tree()
    state["params"] = params
    state["opt_state"] = tx.init(params)
    new, metrics = JT.make_train_step(model, tx, donate=False)(state, arrs, jax.random.key(5))
    out["step"] = {"loss": float(metrics["loss"]), "ntok": int(metrics["ntokens"]),
                   "params": [np.asarray(x) for x in jax.tree.leaves(new["params"])],
                   "mu": [np.asarray(x) for x in jax.tree.leaves(new["opt_state"][0].mu)]}

    qm = Transformer(TransformerConfig(**QCFG))
    qp = qm.init(jax.random.key(21))
    out["q_params"] = jax.tree.map(np.asarray, qp)
    src = _campaign_sources()
    sm = np.asarray(JL.make_src_mask(jnp.asarray(src)))
    payloads = JW.quantize_model_params(qm, qp, 8)
    # JAX's campaign decode (jitted once, reused for every spec), as in
    # tests/test_torch_inject.py, and the rows' BLEUs under JAX's BLEU
    ids, keys = JC.target_ids(qm), tuple(sorted(payloads))
    golden, *faulty = [np.array(JC.faulty_greedy_decode(
        qm, keys, qp, payloads, JC._fault_tree(spec, ids), CAMPAIGN_MAX_LEN,
        jnp.asarray(src), jnp.asarray(sm), 8)) for spec in [None] + _specs(JC, CAMPAIGN_SPECS)]
    refs = [["t1", "t2", "t3"]] * 4

    def bleus(tokens):
        return [JBLEU.sentence_bleu([r], h, smoothing="method4")
                for r, h in zip(refs, jax_ids_to_tokens(tokens, _Vocab))]

    out["campaign"] = {"golden": golden, "faulty": faulty, "golden_bleu": bleus(golden),
                       "faulty_bleu": [bleus(f) for f in faulty]}
    return out


@pytest.fixture(scope="module")
def world(jax_side, tmp_path_factory):
    csv_dir = tmp_path_factory.mktemp("pp_campaign")
    out = P.launch(_world, 4, jax_side["np_params"], jax_side["q_params"], str(csv_dir),
                   timeout_s=600)
    out["csv_dir"] = csv_dir
    return out


# ----------------------------------------------------------------- the tests

@pytest.mark.parametrize("name", list(MESHES))
def test_toy_pipeline_matches_the_sequential_stack(world, name):
    x = np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
    ref = x
    for i in range(4):
        ref = ref @ (np.eye(4, dtype=np.float32) * (i + 1)) + 1.0
    np.testing.assert_allclose(world[name]["toy"], ref, rtol=1e-6)


@pytest.mark.parametrize("name", list(MESHES))
def test_pipelined_forward_matches_jax_over_its_mesh_and_one_device(world, jax_side, name):
    got = world[name]["logits"]
    np.testing.assert_allclose(got, jax_side[name], atol=2e-5)
    np.testing.assert_allclose(got, world["one"]["logits"], atol=2e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_pipelined_gradients_match_jax_grad_of_the_plain_loss(world, jax_side, name):
    got = world[name]["grads"]
    assert len(got) == len(jax_side["grads"]) == len(world["one"]["grads"])
    assert world[name]["mean"] == pytest.approx(world["one"]["mean"], rel=1e-5)
    for g, want, one in zip(got, jax_side["grads"], world["one"]["grads"]):
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, atol=1e-5)
        np.testing.assert_allclose(g, one, atol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_train_step_matches_one_device_and_jax(world, jax_side, name):
    got = world[name]
    for want in (world["one"], jax_side["step"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["ntok"] == want["ntok"]
        for a, b in zip(got["mu"], want["mu"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=1.1e-3)
    assert got["counts_after"] == (1, 1) and got["replicated_equal"]


@pytest.mark.parametrize("name", list(MESHES))
def test_pipe_sends_and_receives_once_per_microbatch_and_boundary(world, name):
    """Each of the two pipelines sends every microbatch's activation across
    each stage boundary once forward and its cotangent once back."""
    pipe = MESHES[name][1]
    for stage, sends, recvs in world[name]["counts"]:
        boundaries = (stage > 0) + (stage < pipe - 1)
        assert sends == recvs == 2 * N_MICRO * boundaries


def test_dropout_steps_keep_the_replicated_leaves_equal(world):
    drop = world["dropout"]
    assert drop["replicated_equal"] and np.isfinite(drop["losses"]).all()
    assert drop["losses"][0] != pytest.approx(world["2x2x1"]["loss"], rel=1e-3)


@pytest.mark.parametrize("case", ["S10", "S9", "S9 dropout"])
def test_sequence_parallel_equals_sp_off(world, case):
    got = world["sp"][case]
    assert got["seq_gathers"][0] == 4 and got["seq_gathers"][1] == 0
    assert got["loss"][0] == pytest.approx(got["loss"][1], rel=1e-6)
    assert got["logits"] <= 1e-6 and got["grads"] <= 1e-6


def test_campaign_over_data_equals_one_device_and_jax(world, jax_side):
    model = P.Transformer(P.TransformerConfig(**QCFG))
    params = P.params_from_jax(jax_side["q_params"], device="cpu")
    payloads = TW.quantize_model_params(model, params, 8)
    src = torch.from_numpy(_campaign_sources())
    sm = L.make_src_mask(src)
    csv_dir = world["csv_dir"]
    for name, entries in (("specs", CAMPAIGN_SPECS), ("random", RANDOM_SPECS)):
        path = f"{csv_dir}/{name}_one.csv"
        one = TC.run_campaign(model, params, payloads, _specs(TC, entries), src, sm,
                              [["t1", "t2", "t3"]] * 4, _Vocab, max_len=CAMPAIGN_MAX_LEN,
                              csv_path=path, fanout=4)
        got = world["campaign"][name]
        assert got["rows"] == one.rows
        np.testing.assert_array_equal(got["golden"], one.golden)
        assert len(got["faulty"]) == len(one.faulty) == len(entries)
        for a, b in zip(got["faulty"], one.faulty):
            np.testing.assert_array_equal(a, b)
        with open(f"{csv_dir}/{name}.csv", "rb") as f, open(path, "rb") as g:
            assert f.read() == g.read()
    want = jax_side["campaign"]
    got = world["campaign"]["specs"]
    np.testing.assert_array_equal(got["golden"], want["golden"])
    for a, b in zip(got["faulty"], want["faulty"]):
        np.testing.assert_array_equal(a, b)
    assert [r["golden_bleu"] for r in got["rows"]] == want["golden_bleu"] * len(CAMPAIGN_SPECS)
    assert [r["faulty_bleu"] for r in got["rows"]] == [b for f in want["faulty_bleu"] for b in f]
    # the faults changed tokens, only on the rows they address: the element
    # faults sit in the second data rank's rows
    changed = np.array([r["tokens_changed"] for r in got["rows"]]).reshape(-1, 4)
    assert changed[1:, :2].sum() == 0 and changed.sum() > 0


def test_stacking_round_trips_and_equals_jax():
    import jax

    from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
    from onnx_transformer_tpu.parallel import pipeline as JPP

    jparams = Transformer(TransformerConfig(**CFG)).init(jax.random.key(0))
    params = P.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    stacked = PP.stack_pipeline_params(params)
    for a, b in zip(tree_leaves(stacked), jax.tree.leaves(JPP.stack_pipeline_params(jparams))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(PP.unstack_pipeline_params(stacked)), tree_leaves(params)):
        assert torch.equal(a, b)


def test_pipeline_param_pspecs_equal_jax():
    import jax
    from jax.sharding import PartitionSpec

    from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
    from onnx_transformer_tpu.parallel import pipeline as JPP

    jparams = JPP.stack_pipeline_params(Transformer(TransformerConfig(**CFG)).init(
        jax.random.key(0)))
    want = jax.tree.map(tuple, JPP.pipeline_param_pspecs(jparams),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    got = PP.pipeline_param_pspecs(PP.stack_pipeline_params(P.params_from_jax(
        jax.tree.map(np.asarray, JPP.unstack_pipeline_params(jparams)), device="cpu")))
    assert got == want


def test_refusals():
    class Mesh:
        pipe, pipe_rank, model, model_rank = 3, 0, 1, 0
        device = torch.device("cpu")

    params = PP.stack_pipeline_params(P.Transformer(P.TransformerConfig(**CFG)).init(
        0, device="cpu"))
    with pytest.raises(ValueError, match="4 encoder layers do not split into pipe=3"):
        PP.shard_pipeline_state(_state(params, P.make_optimizer(32)), Mesh())
    with pytest.raises(ValueError, match="batch 8 not divisible by n_micro 3"):
        PP.pipeline_apply(lambda *a: a[1], {"w": torch.zeros(2, 1)}, torch.zeros(8, 2, 4), {},
                          n_micro=3, mesh=Mesh())
