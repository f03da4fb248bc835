"""The trainer over a (data, model) mesh (``make_train_step(..., mesh=)``,
``shard_state``, ``shard_batch``, the Megatron f/g pair) against the JAX
package's ``make_train_step`` over ``make_mesh`` and against the port's own
one-device step, on the CPU.

One gloo world of 4 ranks (``parallel.launch``) computes every case once
in a module-scoped fixture; JAX runs here over its mesh on the 8 virtual
devices of ``conftest.py``, from the same weights (``params_from_jax``), at
the JAX tests' small configuration (vocabularies 37/31, 2+2 layers,
d_model 32, d_ff 64, 4 heads, dropout 0; base_lr 2.0, warmup 100, as
``tests/test_train.py``'s mesh tests):

- ``data=4``, ``model=4`` and ``data=2 x model=2`` steps: the summed KL
  within rtol 1e-5 of JAX's step over the same mesh and of the port's
  one-device step, the token count equal; the gradients of the whole batch
  (each rank's slices gathered) within rtol 1e-4 / atol 1e-7 of
  ``jax.grad`` of JAX's ``_loss_fn`` on the full batch
  (``tests/test_multihost.py``'s bound) and of the port's one-device
  gradients; Adam's first moment after the step, ``(1 - b1) * g`` of the
  step's own gradient, within rtol 1e-4 / atol 1e-7 of JAX's step's and
  of the one-device step's; the parameters after the step within 1.1e-3
  of JAX's (``tests/test_train.py``'s bound: one Adam step moves a leaf by
  about the learning rate, 3.5e-4 here, whatever its gradient's size, so
  the moment is what holds the step's gradient);
- ``accum=2`` under ``data=2 x model=2``, the same way (loss, moment and
  parameters: the step's accumulation, its division by ``accum`` and its
  sum over ``data``);
- bf16 compute under TP=2: the loss within 2^-8 of the one-device bf16
  step's, the parameters f32;
- dropout 0.3 under ``data=2 x model=2`` (``mesh_generator``): three
  steps, after which the replicated leaves are bit-equal on every rank;
  the data ranks draw different masks;
- dropout 0.3 under ``model=4``: the step equals the one-device step with
  the same seed (loss, moment, parameters), so the sharded heads and FFN
  units draw one device's masks and not one mask repeated on each rank;
- a mesh checkpoint (``gather_state``, written by rank 0) holds the whole
  arrays and restores into a one-device state and into JAX's ``restore``;
- ``model_copy`` (f) and ``model_sum`` (g) forward and backward at 2
  ranks, and no call for f without autograd;
- QAT under TP=2 against the one-device QAT gradients (the view's linear
  taps snapped to one device's), and a sharded per-token fake-quant whose
  maximum ties across ranks against ``jax.grad``.

``jax`` is imported inside the fixtures only: the spawned ranks import this
module to find their function.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import onnx_transformer_tpu_torch as P
from onnx_transformer_tpu_torch.data.dataset import Batch
from onnx_transformer_tpu_torch.parallel import collectives as PC
from onnx_transformer_tpu_torch.parallel.sharding import (gather_params, linear_kind,
                                                          replicated_mask)
from onnx_transformer_tpu_torch.params import tree_leaves, tree_unflatten
from onnx_transformer_tpu_torch.quant import core as TQ
from onnx_transformer_tpu_torch.quant.int4 import make_qat_linear_impl
from onnx_transformer_tpu_torch.train import checkpoint as CK
from onnx_transformer_tpu_torch.train import trainer as T

CFG = (37, 31, 2, 32, 64, 4, 0.0)
LR = dict(base_lr=2.0, warmup=100)
MESHES = {"data4": (4, 1), "model4": (1, 4), "data2_model2": (2, 2)}
DROPOUT_STEPS = 3
# the x of the tie check, split over 2 ranks along its last dim: row 0's
# maximum |x| sits once on each rank, row 1's twice on rank 0 and once on
# rank 1, row 2's once, row 3 is all zeros; u weighs the fake-quant output
TIE_X = np.array([[1.5, -0.5, 0.25, -1.5], [-2.0, 2.0, 1.0, 2.0],
                  [0.5, 0.75, -3.0, 1.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
TIE_U = np.array([[1.0, -2.0, 3.0, 0.5], [0.25, 1.0, -1.0, 2.0],
                  [1.0, 1.0, 1.0, -1.0], [2.0, -1.0, 0.5, 1.0]], np.float32)


def _batch_arrays(seed=0, b=8, s=10, t=9):
    """src, tgt (tests/test_torch_train_step.py:_batch, B divisible by 4,
    pad rows spread so that the data ranks count different tokens)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 37, (b, s)).astype(np.int32)
    src[1, 7:] = 2
    tgt = rng.integers(4, 31, (b, t)).astype(np.int32)
    tgt[:, 0] = 0
    tgt[2, 5:] = 2
    tgt[5, 2:] = 2
    tgt[7, 4:] = 2
    return src, tgt


def _np(tree) -> list:
    return [t.detach().float().numpy().copy() for t in tree_leaves(tree)]


def _state(params, tx):
    return {"params": params, "opt_state": tx.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _replicated(params) -> torch.Tensor:
    """Every replicated leaf, flat, in tree order."""
    keep = tree_leaves(replicated_mask(params))
    return torch.cat([t.reshape(-1) for t, k in zip(tree_leaves(params), keep) if k])


def _same_on_every_rank(t: torch.Tensor) -> bool:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)


def _mesh_case(model, tx, state, arrs, mesh, accum=1, lin=P.default_linear, compute_dtype=None):
    """Loss, count, whole gradients and whole parameters after one step."""
    tm = P.Transformer(model.cfg, mesh)
    sst = P.shard_state(state, mesh)
    sb = P.shard_batch(arrs, mesh, accum)
    out = {}
    if accum == 1:
        (mean, loss, ntok), g = T.value_and_grad(tm, sst["params"], sb,
                                                 lin=P.shard_linear_impl(lin, mesh),
                                                 compute_dtype=compute_dtype)
        out.update(mean=float(mean), grads=_np(gather_params(
            tree_unflatten(sst["params"], g), mesh)))
    step = P.make_train_step(model, tx, mesh=mesh, accum=accum, donate=False, lin=lin,
                             compute_dtype=compute_dtype)
    new, m = step(sst, sb, None)
    whole = T.gather_state(new, mesh)
    out.update(loss=float(m["loss"]), ntok=int(m["ntokens"]), params=_np(whole["params"]),
               mu=_np(whole["opt_state"][0].mu), dtypes={str(t.dtype) for t in tree_leaves(new["params"])},
               counts=(int(new["opt_state"][0].count), int(new["opt_state"][1].count),
                       int(new["step"])),
               replicated_equal=_same_on_every_rank(_replicated(new["params"])))
    return out, new


def _one_device(model, tx, state, arrs, accum=1, lin=P.default_linear, compute_dtype=None):
    out = {}
    if accum == 1:
        (mean, loss, ntok), g = T.value_and_grad(model, state["params"], arrs, lin=lin,
                                                 compute_dtype=compute_dtype)
        out.update(mean=float(mean), grads=[x.float().numpy().copy() for x in g])
    new, m = P.make_train_step(model, tx, accum=accum, donate=False, lin=lin,
                               compute_dtype=compute_dtype)(state, arrs, None)
    out.update(loss=float(m["loss"]), ntok=int(m["ntokens"]), params=_np(new["params"]),
               mu=_np(new["opt_state"][0].mu))
    return out


def _pair_checks(mesh) -> dict:
    """f and g at the model group of 2 ranks of ``mesh``."""
    r = mesh.model_rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    up = torch.full((2, 3), 1.0 + r)
    out = {}
    xs = x.clone().requires_grad_()
    y = P.parallel.model_sum(xs, mesh)
    (y * up).sum().backward()
    out["g"] = (y.detach().numpy(), xs.grad.numpy())
    xf = x.clone().requires_grad_()
    calls = PC.model_copy.calls
    z = P.parallel.model_copy(xf, mesh)
    (z * up).sum().backward()
    out["f"] = (z.detach().numpy(), xf.grad.numpy(), PC.model_copy.calls - calls)
    with torch.no_grad():
        out["f_no_grad"] = P.parallel.model_copy(x, mesh) is x and PC.model_copy.calls == calls + 1
    # a per-token fake-quant of x's columns spread over the two ranks, each
    # rank's part of sum(u * fake_quant(x)), whose scale's maximum ties
    # across the ranks; the gradient gathered whole
    xt = torch.from_numpy(TIE_X[:, 2 * r:2 * r + 2].copy()).requires_grad_()
    u = torch.from_numpy(TIE_U[:, 2 * r:2 * r + 2].copy())
    y = TQ.fake_quant_ste(xt, TQ.act_scale_per_token(xt, 8, mesh), 8)
    (y * u).sum().backward()
    parts = [torch.empty_like(xt.grad) for _ in range(mesh.model)]
    dist.all_gather(parts, xt.grad, group=mesh.model_group)
    out["tie_grad"] = torch.cat(parts, dim=-1).numpy()
    return out


def _tapping(lin, taps, inject=None):
    """``lin`` recording its taps into ``taps`` (and rewriting by ``inject``)."""
    def wrapped(name, x, w, b, t=None, i=None):
        return lin(name, x, w, b, taps, inject)

    wrapped.mesh = lin.mesh
    return wrapped


def _local_tap(key: str, value: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's part of a one-device tap: its batch rows, and for the
    input of a row-parallel linear or the output of a column-parallel one
    its columns."""
    name, out, _ = key.partition(".out")
    kind = linear_kind(name)
    value = P.parallel.local_rows(value, mesh)
    if (kind == "row" and not out) or (kind == "column" and out):
        return value.chunk(mesh.model, -1)[mesh.model_rank]
    return value


def _qat_case(model, params, arrs, mesh) -> dict:
    """QAT gradients of one device and of the tensor-parallel view, as they
    come and with the view's tapped linear inputs and outputs snapped to
    one device's values (the gradient passes through the snap): the
    row-parallel partial sums round in another order, which can flip a
    fake-quant rounding, as the QAT test against JAX snaps the port's
    taps to JAX's (``tests/test_torch_train.py``)."""
    qat = make_qat_linear_impl(4, 8)
    taps1 = {}
    (mean1, _, _), g1 = T.value_and_grad(model, params, arrs, lin=_tapping(qat, taps1))
    tm = P.Transformer(model.cfg, mesh)
    sp, sb = P.shard_params(params, mesh), P.shard_batch(arrs, mesh)
    qt = P.shard_linear_impl(qat, mesh)

    def whole(g):
        return [x.numpy().copy() for x in tree_leaves(gather_params(tree_unflatten(sp, g),
                                                                   mesh))]

    (mean, _, _), g = T.value_and_grad(tm, sp, sb, lin=_tapping(qt, {}))

    def snap(key):
        target = _local_tap(key, taps1[key].detach(), mesh)
        return lambda v: v + (target - v).detach()

    inject = {k: snap(k) for k in taps1}
    (_, _, _), gs = T.value_and_grad(tm, sp, sb, lin=_tapping(qt, {}, inject))
    return {"mean": float(mean), "one_mean": float(mean1), "grads": whole(g),
            "snapped": whole(gs), "one": [x.numpy().copy() for x in g1], "taps": len(taps1)}


def _world(np_params, b8, b16, ckpt):
    """Every case, on each of 4 ranks; rank 0's dict is returned."""
    cfg = P.TransformerConfig(*CFG)
    model = P.Transformer(cfg)
    tx = P.make_optimizer(32, **LR)
    params = P.params_from_jax(np_params, device="cpu")
    state = _state(params, tx)
    arrs = T.batch_to_arrays(Batch.make(*b8), device="cpu")
    arrs16 = T.batch_to_arrays(Batch.make(*b16), 2, device="cpu")
    out = {"one": _one_device(model, tx, state, arrs),
           "one_accum2": _one_device(model, tx, state, arrs16, accum=2)}
    meshes = {name: P.make_mesh(data=d, model=m, device="cpu") for name, (d, m) in MESHES.items()}
    for name, mesh in meshes.items():
        out[name], new = _mesh_case(model, tx, state, arrs, mesh)
    mesh22 = meshes["data2_model2"]
    whole = T.gather_state(new, mesh22)
    if dist.get_rank() == 0:
        CK.save(ckpt, whole)
    out["ckpt_params"] = _np(whole["params"])
    out["accum2"], _ = _mesh_case(model, tx, state, arrs16, mesh22, accum=2)

    out["bf16"], _ = _mesh_case(model, tx, state, arrs, mesh22, compute_dtype=torch.bfloat16)
    out["one_bf16"] = _one_device(model, tx, state, arrs, compute_dtype=torch.bfloat16)

    # dropout 0.3 over the 2 x 2 mesh
    dmodel = P.Transformer(cfg.with_(dropout=0.3))
    step = P.make_train_step(dmodel, tx, mesh=mesh22, donate=False)
    gen = P.mesh_generator(7, mesh22)
    draws = torch.rand(4, generator=P.mesh_generator(7, mesh22))
    sst, sb = P.shard_state(state, mesh22), P.shard_batch(arrs, mesh22)
    losses = []
    for _ in range(DROPOUT_STEPS):
        sst, m = step(sst, sb, gen)
        losses.append(float(m["loss"]))
    out["dropout"] = {"losses": losses, "replicated_equal": _same_on_every_rank(
        _replicated(sst["params"])), "draws": [None] * 4}
    dist.all_gather_object(out["dropout"]["draws"], (mesh22.data_rank, mesh22.model_rank,
                                                     draws.tolist()))

    # dropout 0.3 over model=4 against one device with the same seed
    mesh4 = meshes["model4"]
    new1, m1 = P.make_train_step(dmodel, tx, donate=False)(
        state, arrs, torch.Generator().manual_seed(7))
    new4, m4 = P.make_train_step(dmodel, tx, mesh=mesh4, donate=False)(
        P.shard_state(state, mesh4), P.shard_batch(arrs, mesh4), P.mesh_generator(7, mesh4))
    whole4 = T.gather_state(new4, mesh4)
    out["dropout_tp4"] = {"loss": float(m4["loss"]), "mu": _np(whole4["opt_state"][0].mu),
                          "params": _np(whole4["params"]),
                          "one": {"loss": float(m1["loss"]), "mu": _np(new1["opt_state"][0].mu),
                                  "params": _np(new1["params"])}}

    out["pairs"] = _pair_checks(mesh22)

    out["qat"] = _qat_case(model, params, arrs, mesh22)
    out["calls"] = {c.__name__: c.calls for c in PC.COLLECTIVES}
    return out


def _jax_step(new, metrics) -> dict:
    """Loss, count, parameters and Adam's first moment of a JAX step."""
    import jax

    return {"loss": float(metrics["loss"]), "ntok": int(metrics["ntokens"]),
            "params": [np.asarray(x) for x in jax.tree.leaves(new["params"])],
            "mu": [np.asarray(x) for x in jax.tree.leaves(new["opt_state"][0].mu)]}


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from onnx_transformer_tpu.data.dataset import Batch as JBatch
    from onnx_transformer_tpu.models import transformer as JT
    from onnx_transformer_tpu.parallel.mesh import make_mesh
    from onnx_transformer_tpu.quant import core as JQ
    from onnx_transformer_tpu.train import trainer as JTR

    model = JT.Transformer(JT.TransformerConfig(*CFG))
    tx = JTR.make_optimizer(32, **LR)
    state = JTR.init_state(model, tx, jax.random.key(0)).tree()
    b8, b16 = _batch_arrays(), _batch_arrays(seed=1, b=16)
    arrs = JTR.batch_to_arrays(JBatch.make(*b8))
    arrs16 = JTR.batch_to_arrays(JBatch.make(*b16), 2)
    grad = jax.jit(jax.grad(lambda p, b: JTR._loss_fn(model, p, *b, None, 0.1)[0]))
    out = {"state": state, "b8": b8, "b16": b16,
           "np_params": jax.tree.map(np.asarray, state["params"]),
           "grads": [np.asarray(g) for g in jax.tree.leaves(grad(state["params"], arrs))]}
    for name, (d, m) in MESHES.items():
        mesh = make_mesh(data=d, model=m)
        step = JTR.make_train_step(model, tx, mesh=mesh, donate=False)
        new, metrics = step(JTR.shard_state(state, mesh), JTR.shard_batch(arrs, mesh),
                            jax.random.key(5))
        out[name] = _jax_step(new, metrics)
    mesh = make_mesh(data=2, model=2)
    step = JTR.make_train_step(model, tx, mesh=mesh, accum=2, donate=False)
    new, metrics = step(JTR.shard_state(state, mesh), JTR.shard_batch(arrs16, mesh, accum=2),
                        jax.random.key(5))
    out["accum2"] = _jax_step(new, metrics)
    out["tie_grad"] = np.asarray(jax.grad(lambda x: (JQ.fake_quant_ste(
        x, JQ.act_scale_per_token(x, 8), 8) * jnp.asarray(TIE_U)).sum())(jnp.asarray(TIE_X)))
    return out


@pytest.fixture(scope="module")
def world(jax_side, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt") / "state.npz")
    out = P.launch(_world, 4, jax_side["np_params"], jax_side["b8"], jax_side["b16"], ckpt,
                   timeout_s=600)
    out["ckpt"] = ckpt
    return out


def _close_params(got, want, atol=1.1e-3):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=atol)


def _close_moments(got, want):
    """Adam's first moment after one step, (1 - b1) times the step's
    gradient: a negated, rescaled or wrongly normalised gradient fails."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_step_matches_jax_over_its_mesh(world, jax_side, name):
    got, want = world[name], jax_side[name]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["ntok"] == want["ntok"]
    for g, w in zip(got["grads"], jax_side["grads"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)
    _close_moments(got["mu"], want["mu"])
    _close_params(got["params"], want["params"])
    assert got["counts"] == (1, 1, 1) and got["dtypes"] == {"torch.float32"}


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_step_matches_the_one_device_step(world, name):
    got, one = world[name], world["one"]
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-5)
    assert got["mean"] == pytest.approx(one["mean"], rel=1e-5) and got["ntok"] == one["ntok"]
    for g, w in zip(got["grads"], one["grads"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)
    _close_moments(got["mu"], one["mu"])
    _close_params(got["params"], one["params"])
    assert got["replicated_equal"]


def test_accum2_under_data2_model2_matches_jax_and_one_device(world, jax_side):
    got = world["accum2"]
    for want in (jax_side["accum2"], world["one_accum2"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["ntok"] == want["ntok"]
        _close_moments(got["mu"], want["mu"])
        _close_params(got["params"], want["params"])


def test_bf16_under_tp2(world):
    got, one = world["bf16"], world["one_bf16"]
    assert got["loss"] == pytest.approx(one["loss"], rel=2 ** -8)
    assert got["mean"] == pytest.approx(one["mean"], rel=2 ** -8)
    assert got["dtypes"] == {"torch.float32"} and got["replicated_equal"]
    assert all(np.isfinite(g).all() for g in got["grads"])


def test_dropout_under_tp2_keeps_the_replicated_leaves_equal(world):
    drop = world["dropout"]
    assert drop["replicated_equal"] and np.isfinite(drop["losses"]).all()
    # dropout ran: the first step's loss is not the dropout-0 one
    assert drop["losses"][0] != pytest.approx(world["data2_model2"]["loss"], rel=1e-3)
    by_rank = {(d, m): x for d, m, x in drop["draws"]}
    assert by_rank[0, 0] == by_rank[0, 1] and by_rank[1, 0] == by_rank[1, 1]
    assert by_rank[0, 0] != by_rank[1, 0]


def test_dropout_under_tp4_draws_the_masks_of_one_device(world):
    """Each rank draws the whole tensor's mask for its heads and FFN units
    and keeps its block: the TP=4 step with dropout 0.3 is the one-device
    step with the same seed."""
    got = world["dropout_tp4"]
    one = got["one"]
    assert one["loss"] != pytest.approx(world["one"]["loss"], rel=1e-3)   # dropout ran
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-5)
    _close_moments(got["mu"], one["mu"])
    _close_params(got["params"], one["params"])


def test_mesh_checkpoint_restores_one_device_and_in_jax(world, jax_side):
    from onnx_transformer_tpu.train import checkpoint as JCK

    tx = P.make_optimizer(32, **LR)
    template = T.init_state(P.Transformer(P.TransformerConfig(*CFG)), tx, seed=3,
                            device="cpu").tree()
    restored = CK.restore(world["ckpt"], template)
    assert [tuple(a.shape) for a in tree_leaves(restored["params"])] == [
        a.shape for a in world["ckpt_params"]]
    for a, b in zip(_np(restored["params"]), world["ckpt_params"]):
        np.testing.assert_array_equal(a, b)
    assert int(restored["step"]) == 1 and int(restored["opt_state"][0].count) == 1
    sj = JCK.restore(world["ckpt"], jax_side["state"])
    import jax

    for a, b in zip(jax.tree.leaves(sj["params"]), world["ckpt_params"]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_f_and_g_forward_and_backward_at_two_ranks(world):
    pairs = world["pairs"]
    x0 = np.arange(6, dtype=np.float32).reshape(2, 3)
    y, gx = pairs["g"]
    np.testing.assert_array_equal(y, x0 + (x0 + 10))     # g sums forward
    np.testing.assert_array_equal(gx, np.ones((2, 3)))   # and passes the gradient through
    z, fx, calls = pairs["f"]
    np.testing.assert_array_equal(z, x0)                 # f is the identity forward
    np.testing.assert_array_equal(fx, np.full((2, 3), 3.0))   # and sums 1 + 2 backward
    assert calls == 1 and pairs["f_no_grad"]


def test_sharded_scale_gradient_splits_at_a_tie_as_jax_grad(world, jax_side):
    """A per-token fake-quant whose row maximum ties within and across the
    two ranks (and an all-zero row): the gradient equals ``jax.grad``'s of
    the one-device function, the tie split counted over the group."""
    got, want = world["pairs"]["tie_grad"], jax_side["tie_grad"]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_qat_under_tp2_matches_one_device(world):
    """The loss within rtol 1e-5; the gradients within 1e-5 of the largest
    once the view's linear taps are snapped to one device's, within 1e-2
    as they come (a flipped fake-quant rounding moves a whole step)."""
    qat = world["qat"]
    assert qat["taps"] == 2 * (2 * 6 + 2 * 10 + 1)
    assert qat["mean"] == pytest.approx(qat["one_mean"], rel=1e-5)
    gmax = max(np.abs(g).max() for g in qat["one"])
    for g, s, w in zip(qat["grads"], qat["snapped"], qat["one"]):
        assert np.abs(s - w).max() <= 1e-5 * gmax
        assert np.abs(g - w).max() <= 1e-2 * gmax


def test_every_collective_ran(world):
    calls = world["calls"]
    for name in ("model_sum", "model_copy", "model_max", "model_absmax", "data_sum"):
        assert calls[name] > 0, calls


def test_shard_batch_and_local_rows_split_dim_1_under_accum():
    class Mesh:
        data, data_rank, device = 2, 1, torch.device("cpu")

    arrs = tuple(torch.arange(24).reshape(2, 4, 3) for _ in range(2))
    got = T.shard_batch(arrs, Mesh(), accum=2)
    assert torch.equal(got[0], arrs[0][:, 2:])
    with pytest.raises(ValueError, match="does not split"):
        T.shard_batch((torch.zeros(3, 2),), Mesh())


def test_dropout_generators_follow_the_data_rank():
    a = torch.rand(3, generator=P.mesh_generator(1, None, device="cpu"))
    b = torch.rand(3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
