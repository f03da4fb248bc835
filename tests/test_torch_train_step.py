"""The port's train step, epoch loop and checkpoints against the JAX
package on the CPU, at the JAX tests' small configuration (vocabularies
37/31, 2+2 layers, d_model 32, d_ff 64, 4 heads, dropout 0), and the port's
counterparts of ``tests/test_train.py``'s overfit, accumulation and bf16
trajectory tests.  Tolerances are stated where they are used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.data.dataset import Batch as JBatch
from onnx_transformer_tpu.models import transformer as JT
from onnx_transformer_tpu.train import checkpoint as JCK
from onnx_transformer_tpu.train import trainer as JTR
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.data.dataset import Batch, collate
from onnx_transformer_tpu_torch.data.vocab import SPECIALS, Vocab
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.params import tree_leaves, tree_paths
from onnx_transformer_tpu_torch.quant import int4 as T4
from onnx_transformer_tpu_torch.train import checkpoint as CK
from onnx_transformer_tpu_torch.train import trainer as T
from onnx_transformer_tpu_torch.train.schedule import noam_schedule

CFG_ARGS = (37, 31, 2, 32, 64, 4, 0.0)
LR = dict(base_lr=2.0, warmup=10)


def _batch(seed=0, b=6, s=10, t=9):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 37, (b, s)).astype(np.int32)
    src[1, 7:] = 2
    tgt = rng.integers(4, 31, (b, t)).astype(np.int32)
    tgt[:, 0] = 0
    tgt[2, 5:] = 2
    return JBatch.make(src, tgt)


def _jax_flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class Jax:
    """The JAX model, optimizer and initial state; each train step is
    compiled once per module, on first use."""

    def __init__(self):
        self.model = JT.Transformer(JT.TransformerConfig(*CFG_ARGS))
        self.tx = JTR.make_optimizer(32, **LR)
        self.state = JTR.init_state(self.model, self.tx, jax.random.key(0)).tree()
        self._steps = {}

    def step(self, **kw):
        key = tuple(sorted(kw.items(), key=lambda kv: kv[0]))
        if key not in self._steps:
            self._steps[key] = JTR.make_train_step(self.model, self.tx, donate=False, **kw)
        return self._steps[key]


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _port_state(jx_state):
    """The port's train state from a JAX one (params, moments, counts)."""
    params = params_from_jax(jx_state["params"], device="cpu")
    adam, sched = jx_state["opt_state"]
    opt = (T.ScaleByAdamState(torch.tensor(np.asarray(adam.count)),
                              params_from_jax(adam.mu, device="cpu"),
                              params_from_jax(adam.nu, device="cpu")),
           T.ScaleByScheduleState(torch.tensor(np.asarray(sched.count))))
    return {"params": params, "opt_state": opt, "step": torch.tensor(np.asarray(jx_state["step"]))}


def _model():
    return PT.Transformer(PT.TransformerConfig(*CFG_ARGS))


def _assert_state_close(port, jax_state, lr_sum):
    """Parameters after Adam steps: every leaf within 1e-4 of its largest
    value, except the k-projection biases.  Their gradient is 0 in exact
    arithmetic, and JAX's and the port's f32 noise there differ in sign,
    which Adam's g / (|g| + 1e-9) turns into a whole +-lr step: they are
    held to 2 x the sum of the steps' learning rates."""
    want = _jax_flat(jax_state["params"])
    for key, leaf in tree_paths(port["params"]):
        d = np.abs(leaf.numpy() - want[key]).max()
        if key.endswith("/k/b"):
            assert d <= 2 * lr_sum, (key, d, lr_sum)
        else:
            assert d <= 1e-4 * np.abs(want[key]).max(), (key, d)
    adam, sched = jax_state["opt_state"]
    assert int(port["opt_state"][0].count) == int(adam.count)
    assert int(port["opt_state"][1].count) == int(sched.count)
    assert int(port["step"]) == int(jax_state["step"])


# ----------------------------------------------------------- against JAX

@pytest.mark.parametrize("accum, steps", [(1, 1), (1, 5), (2, 5)])
def test_train_step_matches_jax(jx, accum, steps):
    """The port's make_train_step against JAX's, from the same state over
    the same batches: the summed loss within 1e-6 relative and the token
    count equal at every step, the state as _assert_state_close."""
    stepj = jx.step(accum=accum)
    stept = T.make_train_step(_model(), T.make_optimizer(32, **LR), accum=accum, donate=False)
    sj, st = jx.state, _port_state(jx.state)
    sched = noam_schedule(32, LR["base_lr"], LR["warmup"])
    lr_sum = 0.0
    for i in range(steps):
        b = _batch(seed=20 + i, b=6 * accum)
        lr_sum += float(sched(i))
        sj, mj = stepj(sj, JTR.batch_to_arrays(b, accum), jax.random.key(i))
        st, mt = stept(st, T.batch_to_arrays(b, accum, device="cpu"), None)
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
        assert int(mt["ntokens"]) == int(mj["ntokens"])
    _assert_state_close(st, sj, lr_sum)


def test_bf16_step_matches_jax(jx):
    """compute_dtype=bfloat16: two steps' losses within bf16 tolerance
    (2^-8 relative) of JAX's bf16 step; params, moments stay f32."""
    stepj = jx.step(compute_dtype=jnp.bfloat16)
    stept = T.make_train_step(_model(), T.make_optimizer(32, **LR), donate=False,
                              compute_dtype=torch.bfloat16)
    sj, st = jx.state, _port_state(jx.state)
    for i in range(2):
        b = _batch(seed=30 + i)
        sj, mj = stepj(sj, JTR.batch_to_arrays(b), jax.random.key(i))
        st, mt = stept(st, T.batch_to_arrays(b, device="cpu"), None)
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=2 ** -8)
    assert all(a.dtype == torch.float32 for a in tree_leaves((st["params"], st["opt_state"][0].mu,
                                                              st["opt_state"][0].nu)))


# ------------------------------------------------------ the port's own runs

def _tiny(accum=1, lin=PT.default_linear, compute_dtype=None):
    """tests/test_train.py's tiny setup, weights from a seed."""
    cfg = PT.TransformerConfig(src_vocab_size=16, tgt_vocab_size=16, num_layers=1, d_model=16,
                               d_ff=32, num_heads=2, dropout=0.0)
    model = PT.Transformer(cfg)
    tx = T.make_optimizer(cfg.d_model, base_lr=2.0, warmup=100)
    state = T.init_state(model, tx, seed=0, device="cpu")
    v = Vocab(SPECIALS + [f"t{i}" for i in range(12)])
    pairs = [("t1 t2 t3", "t2 t3"), ("t4 t5", "t5 t4"), ("t1 t4", "t4"), ("t2", "t2 t2")]
    src, tgt = collate(pairs, v, v, max_padding=8)
    step = T.make_train_step(model, tx, accum=accum, donate=False, lin=lin,
                             compute_dtype=compute_dtype)
    return model, tx, state, Batch.make(src, tgt), step


def _losses(step, tree, arrs, n):
    out = []
    for _ in range(n):
        tree, m = step(tree, arrs, None)
        out.append(float(m["loss"]) / max(int(m["ntokens"]), 1))
    return tree, out


def test_overfit_tiny_batch_reduces_loss():
    _, _, state, batch, step = _tiny()
    _, losses = _losses(step, state.tree(), T.batch_to_arrays(batch, device="cpu"), 30)
    assert losses[-1] < losses[0] * 0.5, losses[::10]


def test_accum_microbatching_runs_and_learns():
    _, _, state, batch, step = _tiny(accum=2)
    _, losses = _losses(step, state.tree(), T.batch_to_arrays(batch, 2, device="cpu"), 20)
    assert losses[-1] < losses[0]


def test_qat_train_step_lowers_the_loss():
    """The QAT impl as ``lin``: finite losses that fall on one batch."""
    _, _, state, batch, step = _tiny(lin=T4.make_qat_linear_impl(4, 8))
    _, losses = _losses(step, state.tree(), T.batch_to_arrays(batch, device="cpu"), 20)
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.7, losses[::5]


def test_bf16_mixed_precision_matches_fp32_trajectory():
    """bf16 compute with f32 master weights tracks the f32 loss trajectory
    within 1 % per step over 8 steps (as tests/test_train.py holds JAX's)."""
    cfg = PT.TransformerConfig(src_vocab_size=41, tgt_vocab_size=37, num_layers=2, d_model=32,
                               d_ff=64, num_heads=4, dropout=0.0)
    model = PT.Transformer(cfg)
    tx = T.make_optimizer(cfg.d_model, warmup=10)
    s32 = T.init_state(model, tx, seed=0, device="cpu").tree()
    s16 = T.init_state(model, tx, seed=0, device="cpu").tree()
    step32 = T.make_train_step(model, tx, donate=False)
    step16 = T.make_train_step(model, tx, donate=False, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    l32, l16 = [], []
    for _ in range(8):
        src = rng.integers(4, 41, (8, 10)).astype(np.int32)
        tgt = rng.integers(4, 37, (8, 10)).astype(np.int32)
        tgt[:, 0] = cfg.bos_id
        arrs = T.batch_to_arrays(Batch.make(src, tgt), device="cpu")
        s32, m32 = step32(s32, arrs, None)
        s16, m16 = step16(s16, arrs, None)
        l32.append(float(m32["loss"]) / float(m32["ntokens"]))
        l16.append(float(m16["loss"]) / float(m16["ntokens"]))
    assert all(p.dtype == torch.float32 for p in tree_leaves(s16["params"]))
    for a, b in zip(l32, l16):
        assert abs(a - b) / a < 0.01, (l32, l16)
    assert l16[-1] < l16[0]


def test_donate_updates_in_place():
    _, tx, state, batch, _ = _tiny()
    model = _tiny()[0]
    arrs = T.batch_to_arrays(batch, device="cpu")
    tree = state.tree()
    before = [p.clone() for p in tree_leaves(tree)]
    kept, _ = T.make_train_step(model, tx, donate=False)(tree, arrs, None)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), before))
    donated, _ = T.make_train_step(model, tx)(tree, arrs, None)
    assert donated["params"] is tree["params"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(donated), tree_leaves(kept)))


def test_batch_to_arrays_folds_microbatches():
    _, _, _, batch, _ = _tiny()
    arrs = T.batch_to_arrays(batch, 2, device="cpu")
    assert [tuple(a.shape) for a in arrs] == [(2, 2, 8), (2, 2, 7), (2, 2, 7), (2, 2, 1, 8),
                                              (2, 2, 7, 7)]
    assert arrs[0].dtype == torch.int32 and arrs[3].dtype == torch.bool
    with pytest.raises(ValueError, match="accum"):
        T.batch_to_arrays(batch, 3, device="cpu")


def test_run_epoch_equals_the_steps_it_runs():
    """run_epoch over a loader equals the same steps called by hand (bit
    for bit on the CPU), logs at its log points, and hands a loader's error
    from the prefetch thread to the caller."""
    model, tx, state, batch, _ = _tiny()
    batches = [batch] * 5
    step = T.make_train_step(model, tx, donate=False)
    logs = []
    tree, metrics = T.run_epoch(step, state.tree(), batches, None, log_every=2,
                                log_fn=logs.append)
    manual = state.tree()
    total = tokens = 0.0
    for b in batches:
        manual, m = step(manual, T.batch_to_arrays(b, device="cpu"), None)
        total, tokens = total + float(m["loss"]), tokens + int(m["ntokens"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(manual)))
    assert metrics["tokens"] == tokens
    assert metrics["loss_per_token"] == pytest.approx(total / tokens, rel=1e-6)
    assert len(logs) == 2 and logs[0].startswith("step     1")

    def broken():
        yield batch
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        T.run_epoch(step, state.tree(), broken(), None, log_every=0)


# ----------------------------------------------------------------- checkpoints

def test_checkpoint_resume_is_exact(tmp_path):
    """Save at step 3, restore into a fresh state, and step 4 equals the
    uninterrupted run's bit for bit; dtypes kept (counts and step int32)."""
    model, tx, state, batch, step = _tiny()
    arrs = T.batch_to_arrays(batch, device="cpu")
    tree, _ = _losses(step, state.tree(), arrs, 3)
    path = str(tmp_path / "ck.npz")
    CK.save(path, tree)
    restored = CK.restore(path, T.init_state(model, tx, seed=9, device="cpu").tree())
    for (k, a), b in zip(tree_paths(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert restored["opt_state"][0].count.dtype == restored["step"].dtype == torch.int32
    t1, m1 = step(tree, arrs, None)
    t2, m2 = step(restored, arrs, None)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t1), tree_leaves(t2)))
    with pytest.raises(KeyError, match="missing leaf"):
        CK.restore(path, {**tree, "extra": torch.zeros(1)})
    CK.save_params_with_meta(str(tmp_path / "p.npz"), tree["params"], {"step": 3})
    assert CK.load_meta(str(tmp_path / "p.npz")) == {"step": 3}


def test_jax_checkpoint_restores_in_the_port(jx, tmp_path):
    """A train state saved by the JAX package after two steps restores in
    the port under the same keys and dtypes, and the port's next step
    matches JAX's next step as in test_train_step_matches_jax."""
    stepj = jx.step()
    sj = jx.state
    for i in range(2):
        sj, _ = stepj(sj, JTR.batch_to_arrays(_batch(seed=40 + i)), jax.random.key(i))
    path = str(tmp_path / "jax.npz")
    JCK.save(path, sj)
    with np.load(path) as z:
        keys = set(z.files)
        assert z["opt_state/0/.count"].dtype == np.int32
    template = T.init_state(_model(), T.make_optimizer(32, **LR), seed=1, device="cpu").tree()
    assert keys == {k for k, _ in tree_paths(template)}
    assert len(keys) - 92 == 187
    st = CK.restore(path, template)
    b = _batch(seed=42)
    sj, mj = stepj(sj, JTR.batch_to_arrays(b), jax.random.key(2))
    st, mt = T.make_train_step(_model(), T.make_optimizer(32, **LR))(
        st, T.batch_to_arrays(b, device="cpu"), None)
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
    _assert_state_close(st, sj, sum(float(noam_schedule(32, 2.0, 10)(i)) for i in range(3)))


def test_port_checkpoint_restores_in_jax(jx, tmp_path):
    """A train state saved by the port after two steps restores in the JAX
    package bit for bit, with JAX's dtypes, and JAX's step runs on it."""
    model, tx = _model(), T.make_optimizer(32, **LR)
    step = T.make_train_step(model, tx)
    st = _port_state(jx.state)
    for i in range(2):
        st, _ = step(st, T.batch_to_arrays(_batch(seed=50 + i), device="cpu"), None)
    path = str(tmp_path / "port.npz")
    CK.save(path, st)
    sj = JCK.restore(path, jx.state)
    want = {k: v.numpy() for k, v in tree_paths(st)}
    got = _jax_flat(sj)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, m = jx.step()(sj, JTR.batch_to_arrays(_batch(seed=52)), jax.random.key(0))
    assert np.isfinite(float(m["loss"]))
