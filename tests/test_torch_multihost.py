"""Multi-process data-parallel training (``parallel.multihost``), the port's
counterpart of ``tests/test_multihost.py`` and ``tests/multihost_worker.py``.

Two gloo ranks (``parallel.launch``, one process each; the counterpart of
the JAX test's two ``jax.distributed`` processes) each load only their
shard of a synthetic corpus (``BucketedLoader(num_shards=2,
shard_index=rank)``), replicate the train state from rank 0
(``replicate_tree``: rank 1 starts from other parameters on purpose), and
take four steps of ``make_train_step(..., mesh=make_mesh(data=2))`` over
``global_batch`` of their local batches:

- the ranks step through the same bucket shapes;
- their parameters are identical after the steps, and a rank whose batch
  shape differs is refused;
- against one process on the concatenated batches (rank 0's rows first),
  within that file's bounds: the first gradients within rtol 1e-4 / atol
  1e-7 of ``jax.grad`` of JAX's ``_loss_fn``, the losses within rtol 1e-5
  of JAX's one-process steps and of the port's, the parameters within
  5e-2 of JAX's (Adam turns ulp-level gradient noise near zero into
  sign-like updates) and within 1e-4 of the largest value of each leaf of
  the port's one-process step (the k-projection biases, whose gradient is
  0 in exact arithmetic, within 2 x the sum of the learning rates).

``jax`` is imported inside the tests only: the spawned ranks import this
module to find their function.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import onnx_transformer_tpu_torch as P
from onnx_transformer_tpu_torch.data.vocab import Vocab
from onnx_transformer_tpu_torch.params import tree_leaves, tree_map, tree_paths, tree_unflatten
from onnx_transformer_tpu_torch.train import trainer as T

WORDS = ["<s>", "</s>", "<blank>", "<unk>"] + [f"w{i}" for i in range(40)]
CFG = dict(src_vocab_size=len(WORDS), tgt_vocab_size=len(WORDS), num_layers=2, d_model=16,
           d_ff=32, num_heads=2, dropout=0.0)
STEPS = 4


def synthetic_pairs(n=96, seed=7):
    """tests/multihost_worker.py:synthetic_pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        ls, lt = int(rng.integers(3, 20)), int(rng.integers(3, 20))
        pairs.append((" ".join(f"w{rng.integers(4, 40)}" for _ in range(ls)),
                      " ".join(f"w{rng.integers(4, 40)}" for _ in range(lt))))
    return pairs


def _rank(np_params):
    rank = dist.get_rank()
    mesh = P.make_mesh(data=2, device="cpu")
    vocab = Vocab(WORDS, default_index=3)
    # the worker's loader: token budget 192, so every bucket's batch is even
    loader = P.BucketedLoader(synthetic_pairs(), vocab, vocab, token_budget=192,
                              max_padding=24, shuffle=True, seed=3, num_shards=mesh.data,
                              shard_index=mesh.data_rank, use_native=False,
                              length_buckets=(8, 16, 24))
    batches = list(loader)
    model = P.Transformer(P.TransformerConfig(**CFG))
    tx = P.make_optimizer(16, warmup=10)
    params = P.params_from_jax(np_params, device="cpu")
    if rank == 1:   # replicate_tree must hand rank 0's state to every rank
        params = tree_map(lambda x: x + 1.0, params)
    state = P.replicate_tree({"params": params, "opt_state": tx.init(params),
                              "step": torch.zeros((), dtype=torch.int32)}, mesh)
    step = P.make_train_step(model, tx, mesh=mesh, donate=False)
    first = P.global_batch(T.batch_to_arrays(batches[0], device="cpu"), mesh)
    _, g0 = T.value_and_grad(P.Transformer(model.cfg, mesh), state["params"], first)
    local, losses = [], []
    for b in batches[:STEPS]:
        arrs = T.batch_to_arrays(b, device="cpu")
        local.append([a.numpy().copy() for a in arrs])
        state, m = step(state, P.global_batch(arrs, mesh), None)
        losses.append(float(m["loss"]))
    try:
        P.global_batch((np.zeros((2 + rank, 3), np.int32),), mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    mine = {"shapes": [tuple(b.src.shape) for b in batches], "losses": losses,
            "params": [P.parallel.fetch_replicated(x) for x in tree_leaves(state["params"])],
            "local": local, "refused": refused}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return {"ranks": everyone, "grads0": [g.numpy().copy() for g in g0]}


@pytest.fixture(scope="module")
def jax_init():
    import jax

    from onnx_transformer_tpu import Transformer, TransformerConfig
    from onnx_transformer_tpu.train import trainer as JTR

    model = Transformer(TransformerConfig(**CFG))
    tx = JTR.make_optimizer(16, warmup=10)
    state = JTR.init_state(model, tx, jax.random.key(0)).tree()
    return model, tx, state


@pytest.fixture(scope="module")
def two_ranks(jax_init):
    import jax

    _, _, state = jax_init
    return P.launch(_rank, 2, jax.tree.map(np.asarray, state["params"]), timeout_s=300)


def _concat(run, i):
    r0, r1 = run["ranks"][0]["local"][i], run["ranks"][1]["local"][i]
    return tuple(np.concatenate([a, b], axis=0) for a, b in zip(r0, r1))


def test_lockstep_bucket_shapes(two_ranks):
    w0, w1 = two_ranks["ranks"]
    assert len(w0["shapes"]) > 2 and w0["shapes"] == w1["shapes"]


def test_ranks_agree(two_ranks):
    w0, w1 = two_ranks["ranks"]
    assert w0["losses"] == w1["losses"]
    for a, b in zip(w0["params"], w1["params"]):
        np.testing.assert_array_equal(a, b)
    assert all("differ in shape" in w["refused"] for w in (w0, w1))


def test_matches_one_process_on_the_concatenated_batches(two_ranks, jax_init):
    import jax

    from onnx_transformer_tpu.train import trainer as JTR

    model, tx, state = jax_init
    gjit = jax.jit(lambda p, b: jax.grad(
        lambda pp: JTR._loss_fn(model, pp, *b, None, 0.1)[0])(p))
    g = gjit(state["params"], _concat(two_ranks, 0))
    for got, want in zip(two_ranks["grads0"], jax.tree.leaves(g)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-7)

    step = JTR.make_train_step(model, tx, donate=False)
    pm = P.Transformer(P.TransformerConfig(**CFG))
    ptx = P.make_optimizer(16, warmup=10)
    params = P.params_from_jax(jax.tree.map(np.asarray, state["params"]), device="cpu")
    pstate = {"params": params, "opt_state": ptx.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    pstep = P.make_train_step(pm, ptx, donate=False)
    rng = jax.random.key(5)
    jlosses, plosses = [], []
    for i in range(STEPS):
        batch = _concat(two_ranks, i)
        rng, sub = jax.random.split(rng)
        state, mj = step(state, batch, sub)
        pstate, mp = pstep(pstate, tuple(torch.from_numpy(a) for a in batch), None)
        jlosses.append(float(mj["loss"]))
        plosses.append(float(mp["loss"]))
    losses = two_ranks["ranks"][0]["losses"]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(losses, plosses, rtol=1e-5)
    got = two_ranks["ranks"][0]["params"]
    want = [np.asarray(x) for x in jax.tree.leaves(state["params"])]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=5e-2)
    # against the port's one process, as tests/test_torch_train_step.py holds
    # the port's step to JAX's: every leaf within 1e-4 of its largest value
    # but the k-projection biases, whose gradient is 0 in exact arithmetic
    # and f32 noise whose sign Adam turns into whole +-lr steps
    lr_sum = sum(float(ptx.sched(torch.tensor(i))) for i in range(STEPS))
    for a, (key, b) in zip(got, tree_paths(pstate["params"])):
        d = np.abs(a - b.numpy()).max()
        assert d <= (2 * lr_sum if key.endswith("/k/b") else 1e-4 * np.abs(a).max()), (key, d)


def test_replicate_tree_and_fetch_replicated_in_one_process():
    """Without a world of several ranks the broadcast needs a group: one
    rank over gloo gives the tree back on the mesh's device, equal."""
    tree = {"a": [torch.arange(3.0), torch.ones(2, dtype=torch.int32)],
            "b": (torch.zeros(()),)}
    out = P.launch(_replicate_one, 1, tree, timeout_s=60)
    for x, y in zip(tree_leaves(tree), tree_leaves(out)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert isinstance(tree_unflatten(tree, tree_leaves(out))["b"], tuple)


def _replicate_one(tree):
    mesh = P.make_mesh(data=1, device="cpu")
    out = P.replicate_tree(tree, mesh)
    assert isinstance(P.parallel.fetch_replicated(out["a"][0]), np.ndarray)
    return out
