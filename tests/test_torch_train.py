"""The port's training numerics against the JAX package on the CPU, at the
JAX tests' small configuration (vocabularies 37/31, 2+2 layers, d_model 32,
d_ff 64, 4 heads, dropout 0, weights from ``jax.random.key(0)`` carried
across with ``params_from_jax``): the Noam schedule, the label-smoothed KL,
the gradients of the training loss against ``jax.grad`` (f32, the QAT
fake-quant linear, bf16 compute), dropout's properties, and the Adam +
Noam update against optax.  Each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onnx_transformer_tpu.data.dataset import Batch as JBatch
from onnx_transformer_tpu.models import transformer as JT
from onnx_transformer_tpu.quant import int4 as J4
from onnx_transformer_tpu.train import loss as JL
from onnx_transformer_tpu.train import schedule as JS
from onnx_transformer_tpu.train import trainer as JTR
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.params import tree_leaves, tree_map, tree_paths
from onnx_transformer_tpu_torch.quant import core as TQ
from onnx_transformer_tpu_torch.quant import int4 as T4
from onnx_transformer_tpu_torch.train import loss as TL
from onnx_transformer_tpu_torch.train import schedule as TS
from onnx_transformer_tpu_torch.train import trainer as TTR

CFG_ARGS = (37, 31, 2, 32, 64, 4, 0.0)
# the gradient parity bound, as a share of the tree's largest gradient
GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jm = JT.Transformer(JT.TransformerConfig(*CFG_ARGS))
    jp = jm.init(jax.random.key(0))
    pm = PT.Transformer(PT.TransformerConfig(*CFG_ARGS))
    return jm, jp, pm, params_from_jax(jp, device="cpu")


def _batch(seed=0, b=6, s=10, t=9):
    """A JAX-package Batch with padded sources and targets."""
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


def _port_grads(pm, pp, batch, lin=PT.default_linear, compute_dtype=None, rng=None,
                inject=None):
    """(loss / ntok, {path: grad}) of the port's training loss."""
    if inject is not None:
        lin = _injecting(lin, inject)
    (mean, _, _), grads = TTR.value_and_grad(pm, pp, TTR.batch_to_arrays(batch, device="cpu"),
                                             rng, 0.1, lin, compute_dtype)
    return float(mean), {k: g.numpy() for (k, _), g in zip(tree_paths(pp), grads)}


def _injecting(lin, inject):
    def wrapped(name, x, w, b, taps=None, inj=None):
        return lin(name, x, w, b, taps, inject)
    return wrapped


# ------------------------------------------------------------- schedule, loss

@pytest.mark.parametrize("d_model, factor, warmup", [(512, 1.0, 3000), (32, 2.0, 100)])
def test_noam_schedule_matches_jax(d_model, factor, warmup):
    """Bit-equal: the same float32 arithmetic (step 0 taken as 1)."""
    rj = JS.noam_schedule(d_model, factor, warmup)
    rt = TS.noam_schedule(d_model, factor, warmup)
    for step in (0, 1, 100, 3000, 10000):
        want = np.asarray(rj(jnp.asarray(step, jnp.int32)))
        assert rt(step).numpy() == want
        assert rt(torch.tensor(step, dtype=torch.int32)).numpy() == want


@pytest.mark.parametrize("n, v", [(40, 31), (300, 4444)])
def test_label_smoothing_loss_matches_jax(n, v):
    """label_smoothing_loss and loss_and_ntokens within 1e-6 relative of
    the JAX package's on random log-probs with pad targets."""
    rng = np.random.default_rng(v)
    logits = rng.normal(size=(n, v)).astype(np.float32) * 3
    logp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    targets = rng.integers(0, v, n).astype(np.int32)
    targets[::5] = 2
    want = float(JL.label_smoothing_loss(jnp.asarray(logp), jnp.asarray(targets), 2, 0.1))
    got = float(TL.label_smoothing_loss(torch.from_numpy(logp), torch.from_numpy(targets), 2, 0.1))
    assert got == pytest.approx(want, rel=1e-6)
    lj, nj = JL.loss_and_ntokens(jnp.asarray(logp.reshape(4, n // 4, v)),
                                 jnp.asarray(targets.reshape(4, n // 4)), 2, 0.1)
    lt, nt = TL.loss_and_ntokens(torch.from_numpy(logp.reshape(4, n // 4, v)),
                                 torch.from_numpy(targets.reshape(4, n // 4)), 2, 0.1)
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    assert nt.dtype == torch.int32 and int(nt) == int(nj) == int((targets != 2).sum())


def test_closed_form_equals_explicit_kl():
    """The closed form against Σ p (log p − log q) over smoothed_true_dist
    (0·log 0 = 0, pad rows 0), in f64, within 1e-5 relative; the explicit
    distribution equals the JAX package's bit for bit."""
    rng = np.random.default_rng(3)
    v = 9
    logits = rng.normal(size=(12, v)).astype(np.float32)
    logp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    targets = rng.integers(0, v, 12).astype(np.int32)
    targets[[0, 5]] = 2
    d = TL.smoothed_true_dist(torch.from_numpy(targets), v, 2, 0.1).numpy()
    np.testing.assert_array_equal(d, np.asarray(JL.smoothed_true_dist(jnp.asarray(targets), v,
                                                                      2, 0.1)))
    assert (d[[0, 5]] == 0).all() and (d[:, 2] == 0).all()
    d64 = d.astype(np.float64)
    explicit = np.sum(np.where(d64 > 0, d64 * (np.log(np.where(d64 > 0, d64, 1)) - logp), 0.0))
    got = float(TL.label_smoothing_loss(torch.from_numpy(logp), torch.from_numpy(targets), 2, 0.1))
    assert got == pytest.approx(explicit, rel=1e-5)


# ------------------------------------------------------------------ gradients

@pytest.fixture(scope="module")
def jax_f32(setup):
    jm, jp, _, _ = setup
    arrs = JTR.batch_to_arrays(_batch())
    fn = jax.jit(jax.value_and_grad(
        lambda p: JTR._loss_fn(jm, p, *arrs, None, 0.1)[0]))
    loss, grads = fn(jp)
    return float(loss), _jax_flat(grads)


def test_gradients_match_jax_grad(setup, jax_f32):
    """f32, dropout 0: the loss within 1e-6 relative and every gradient
    within GRAD_TOL of the tree's largest gradient.  (The k-projection
    biases' gradient is 0 in exact arithmetic, since softmax ignores a
    constant added to a row of scores: both read f32 noise there, so the
    comparison is against the tree's largest gradient, not leaf by leaf.)"""
    _, _, pm, pp = setup
    lj, gj = jax_f32
    lt, gt = _port_grads(pm, pp, _batch())
    assert lt == pytest.approx(lj, rel=1e-6)
    assert set(gt) == set(gj) and len(gt) == 92
    gmax = max(np.abs(g).max() for g in gj.values())
    worst = max(np.abs(gt[k] - gj[k]).max() for k in gj)
    assert worst <= GRAD_TOL * gmax, worst / gmax
    for k in gj:
        if k.endswith("/k/b"):
            assert np.abs(gj[k]).max() < 1e-6 * gmax


@pytest.mark.parametrize("name", ["encoder.layers.0.self_attn.linears.0",
                                  "decoder.layers.1.feed_forward.w_1", "generator.proj"])
def test_qat_linear_gradients_match_jax(name):
    """One fake-quant linear of the QAT impl (W4 per channel, A8 per token,
    the q projection's output fake-quantized too) on identical inputs: the
    output and the gradients of x, w and b within 1e-6 of their largest."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 16)) * 0.3).astype(np.float32)
    b = (rng.normal(size=16) * 0.1).astype(np.float32)
    dy = rng.normal(size=(3, 5, 16)).astype(np.float32)
    jl, tl = J4.make_qat_linear_impl(4, 8), T4.make_qat_linear_impl(4, 8)

    def fj(x, w, b):
        return jnp.sum(jl(name, x, w, b) * dy)

    yj = np.asarray(jl(name, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    gj = jax.grad(fj, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    yt = tl(name, xt, wt, bt)
    gt = torch.autograd.grad((yt * torch.from_numpy(dy)).sum(), (xt, wt, bt))
    np.testing.assert_allclose(yt.detach().numpy(), yj, rtol=0, atol=1e-6 * np.abs(yj).max())
    for a, e in zip(gt, gj):
        e = np.asarray(e)
        np.testing.assert_allclose(a.numpy(), e, rtol=0, atol=1e-6 * np.abs(e).max())


def _qat_quant_sites(taps: dict) -> list:
    """The QAT impl's activation fake-quant inputs among the linears' taps:
    every attention and FFN linear's input, and the q/k/v projections'
    outputs."""
    out = []
    for k in taps:
        base = k[:-len(".out")] if k.endswith(".out") else k
        if ".linears." not in base and "feed_forward" not in base:
            continue
        if k.endswith(".out") and not base.endswith((".linears.0", ".linears.1", ".linears.2")):
            continue
        out.append(k)
    return out


def test_qat_model_gradients_match_jax_grad(setup):
    """The QAT impl (make_qat_linear_impl(4, 8)) over the whole model.

    The loss must agree within 1e-6 relative.  The gradients need a bound
    of their own, set by the flips of two discontinuities.  Where the two
    frameworks' f32 values of a fake-quant input differ by an ulp and x / s
    lies near .5, round() moves by a whole step; and where a FFN
    pre-activation is 0 in exact arithmetic (4-bit weights and 8-bit
    activations sum to an integer 0, the biases start at 0), its sign, and
    so the ReLU's gate, is the rounding's.  The straight-through gradient
    carries either on.  The test counts the flips from the taps of both
    forwards (rounding flips with the port's quantizer on both values, gate
    flips by sign) and holds the port to what they leave: with no flip,
    the f32 bound (GRAD_TOL of the largest gradient); with flips, it runs
    the port again with the value at every tap of every linear set to
    JAX's (the same values, its own gradient path), which undoes every
    counted flip, and that run must meet the f32 bound.  So the whole
    difference is the counted flips', which must also be few: under 1 in
    1,000 of the values at those sites."""
    jm, jp, pm, pp = setup
    batch = _batch()
    arrs = JTR.batch_to_arrays(batch)
    jlin = J4.make_qat_linear_impl(4, 8)

    def loss_and_taps(p):
        taps = {}

        def lin(name, x, w, b, t=None, inj=None):
            return jlin(name, x, w, b, taps)

        return JTR._loss_fn(jm, p, *arrs, None, 0.1, lin)[0], taps

    (lj, taps_j), gj = jax.jit(jax.value_and_grad(loss_and_taps, has_aux=True))(jp)
    gj = _jax_flat(gj)
    taps_j = {k: np.array(v) for k, v in taps_j.items()}
    gmax = max(np.abs(g).max() for g in gj.values())

    tlin = T4.make_qat_linear_impl(4, 8)
    taps_t = {}

    def tapping(name, x, w, b, t=None, inj=None):
        return tlin(name, x, w, b, taps_t)

    lt, gt = _port_grads(pm, pp, batch, lin=tapping)
    assert lt == pytest.approx(float(lj), rel=1e-6)
    assert set(taps_t) == set(taps_j)
    sites = _qat_quant_sites(taps_j)
    assert len(sites) == 2 * 6 + 2 * 10 + 2 * 3 + 2 * 6

    flips = values = 0
    for k in sites:
        xj, xt = torch.from_numpy(taps_j[k]), taps_t[k].detach()
        qj = torch.round(xj / TQ.act_scale_per_token(xj))
        flips += int((qj != torch.round(xt / TQ.act_scale_per_token(xt))).sum())
        values += xj.numel()
    for k in taps_j:
        if k.endswith("feed_forward.w_1.out"):
            flips += int(((taps_j[k] > 0) != (taps_t[k].detach().numpy() > 0)).sum())
            values += taps_j[k].size
    assert flips < values / 1000, (flips, values)
    worst = max(np.abs(gt[k] - gj[k]).max() for k in gj)
    if flips == 0:
        assert worst <= GRAD_TOL * gmax, worst / gmax

    def snap(k):
        target = torch.from_numpy(taps_j[k])
        return lambda v: v + (target - v).detach()

    _, gs = _port_grads(pm, pp, batch, lin=tlin, inject={k: snap(k) for k in taps_j})
    snapped = max(np.abs(gs[k] - gj[k]).max() for k in gj)
    assert snapped <= GRAD_TOL * gmax, (snapped / gmax, worst / gmax, flips)


def test_dropout_properties(setup):
    """JAX's dropout masks come from jax.random and cannot be matched; the
    port is held to the properties: the same generator seed repeats the
    loss and the gradients exactly, another seed changes them, and at rate
    0 the training forward equals the eval forward."""
    _, _, _, pp = setup
    pm = PT.Transformer(PT.TransformerConfig(*CFG_ARGS[:-1], 0.3))
    batch = _batch()
    runs = [_port_grads(pm, pp, batch, rng=torch.Generator().manual_seed(s)) for s in (4, 4, 5)]
    assert runs[0][0] == runs[1][0] and runs[0][0] != runs[2][0]
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])
    p0 = PT.Transformer(PT.TransformerConfig(*CFG_ARGS))
    arrs = TTR.batch_to_arrays(batch, device="cpu")
    with torch.no_grad():
        train = p0.forward(pp, *arrs[:2], *arrs[3:], rng=torch.Generator().manual_seed(4),
                           train=True)
        evald = p0.forward(pp, *arrs[:2], *arrs[3:])
    assert torch.equal(train, evald)


def test_bf16_compute_matches_jax(setup):
    """compute_dtype=bfloat16 casts every leaf inside the loss: every tapped
    intermediate of the port's forward is bf16, as JAX's, and the loss is
    within bf16 tolerance (2^-8 relative) of JAX's bf16 loss, with f32
    gradients for the f32 master weights."""
    jm, jp, pm, pp = setup
    batch = _batch()
    arrs = JTR.batch_to_arrays(batch)

    def taps_of(p):
        taps = {}
        jm.forward(jax.tree.map(lambda a: a.astype(jnp.bfloat16), p), *arrs[:2], *arrs[3:],
                   taps=taps)
        return taps

    dt_j = {k: str(v.dtype) for k, v in jax.eval_shape(taps_of, jp).items()}
    taps_t = {}
    arrs_t = TTR.batch_to_arrays(batch, device="cpu")
    with torch.no_grad():
        pm.forward(tree_map(lambda p: p.to(torch.bfloat16), pp), *arrs_t[:2], *arrs_t[3:],
                   taps=taps_t)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in taps_t.items()} == dt_j
    assert set(dt_j.values()) == {"bfloat16"}
    lj = float(jax.jit(lambda p: JTR._loss_fn(jm, p, *arrs, None, 0.1,
                                              compute_dtype=jnp.bfloat16)[0])(jp))
    lt, gt = _port_grads(pm, pp, batch, compute_dtype=torch.bfloat16)
    assert lt == pytest.approx(lj, rel=2 ** -8)
    assert all(g.dtype == np.float32 for g in gt.values())


# ------------------------------------------------------------------ optimizer

def test_optimizer_matches_optax(setup, jax_f32):
    """Five Adam(0.9, 0.98, 1e-9) + Noam updates fed JAX's gradients of the
    training loss, each step's scaled by its own factor (signs flip and
    magnitudes change, as between batches), given to optax and to the
    port: parameters and moments within 1e-6 relative (and 1e-6 of a
    leaf's largest value, for the elements that a subtraction brought near
    0); the counts equal."""
    _, jp, _, _ = setup
    grads = _jax_flat_tree(jp, jax_f32[1])
    tx_j = JTR.make_optimizer(32, base_lr=2.0, warmup=10)
    tx_t = TTR.make_optimizer(32, base_lr=2.0, warmup=10)
    state_j = tx_j.init(jp)
    params_j = jp
    params_t = params_from_jax(jp, device="cpu")
    state_t = tx_t.init(params_t)

    @jax.jit
    def optax_step(g, state, params):
        updates, state = tx_j.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for factor in (1.0, -0.5, 2.0, 0.25, -1.0):
        g = jax.tree.map(lambda a: a * np.float32(factor), grads)
        params_j, state_j = optax_step(g, state_j, params_j)
        gt = [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(g)]
        tx_t.update_(tree_leaves(params_t), gt, state_t)
    for got, want in ((params_t, params_j), (state_t[0].mu, state_j[0].mu),
                      (state_t[0].nu, state_j[0].nu)):
        for (k, a), b in zip(tree_paths(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                       err_msg=k)
    assert int(state_t[0].count) == int(state_j[0].count) == 5
    assert int(state_t[1].count) == int(state_j[1].count) == 5
    assert state_t[0].count.dtype == state_t[1].count.dtype == torch.int32


def _jax_flat_tree(template, flat: dict):
    """{path: array} back into ``template``'s JAX structure."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    keys = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])
