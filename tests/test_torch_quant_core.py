"""Port of quant/core.py against the JAX package: int8 payloads and scales
must be bit-equal (both quantize by a true division and round half to even)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.quant import core as JQ
from onnx_transformer_tpu_torch.quant import core as TQ


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10.0)).astype(np.float32)
    x[0] = 0.0   # an all-zero row exercises the 1e-5 scale floor
    return x


@pytest.mark.parametrize("shape,seed", [((7, 33), 0), ((3, 5, 64), 1), ((16, 512), 2)])
def test_per_token_quantize_bit_equal(shape, seed):
    x = _x(shape, seed)
    qj, sj = JQ.quantize_act_per_token(jnp.asarray(x))
    qt, st = TQ.quantize_act_per_token(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        TQ.fake_quant_act_per_token(torch.from_numpy(x)).numpy(),
        np.asarray(JQ.fake_quant_act_per_token(jnp.asarray(x))))


@pytest.mark.parametrize("shape,seed", [((33, 17), 3), ((512, 2048), 4)])
def test_weight_per_channel_bit_equal(shape, seed):
    w = _x(shape, seed)
    wj, sj = JQ.quantize_weight_per_channel(jnp.asarray(w))
    wt, st = TQ.quantize_weight_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_round_half_to_even():
    # absmax 127 -> scale exactly 1.0, so x / s lands on the .5 points
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]], np.float32)
    qt, st = TQ.quantize_act_per_token(torch.from_numpy(x))
    qj, _ = JQ.quantize_act_per_token(jnp.asarray(x))
    assert float(st) == 1.0
    np.testing.assert_array_equal(qt.numpy(), [[127, 0, 2, 2, 0, -2, 4, -126]])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_scalar_helpers():
    assert TQ.SCALE_FLOOR == JQ.SCALE_FLOOR
    assert [TQ.qmax_for(b) for b in (4, 8)] == [JQ.qmax_for(b) for b in (4, 8)] == [7, 127]
    x = _x((5, 9), 5)
    np.testing.assert_array_equal(
        TQ.absmax_scale(torch.from_numpy(x), axis=0, keepdims=False).numpy(),
        np.asarray(JQ.absmax_scale(jnp.asarray(x), axis=0, keepdims=False)))
    q = torch.from_numpy(np.arange(-4, 5, dtype=np.int8))
    s = torch.tensor(0.25)
    np.testing.assert_array_equal(TQ.dequantize(q, s).numpy(),
                                  np.asarray(JQ.dequantize(jnp.asarray(q.numpy()), jnp.float32(0.25))))
    # true_div is an IEEE division, not a multiply by the reciprocal
    a = torch.from_numpy(np.random.default_rng(6).uniform(1e-3, 10, 4096).astype(np.float32))
    np.testing.assert_array_equal(TQ.true_div(a, 127).numpy(), a.numpy() / np.float32(127))


@pytest.mark.parametrize("fn", ["absmax_scale", "quantize_weight_per_tensor"])
def test_scale_floor_gradient_splits_at_the_tie(fn):
    """F8: at |x|max == float32(1e-5) the floor's gradient splits in half,
    as jnp.clip's does: d scale / d x[argmax] = 0.5 / 127, where a
    clamp_min floor passes 1 / 127.  Elsewhere the floor passes all of it
    (above 1e-5) or none (below).  The values are unchanged."""
    import jax

    def jax_scale(x):
        if fn == "absmax_scale":
            return JQ.absmax_scale(x, axis=None, keepdims=False)
        return JQ.quantize_weight_per_tensor(x)[1]

    def torch_scale(x):
        if fn == "absmax_scale":
            return TQ.absmax_scale(x, axis=None, keepdims=False)
        return TQ.quantize_weight_per_tensor(x)[1]

    for top in (np.float32(1e-5), np.float32(3e-5), np.float32(2e-6)):
        x = np.array([top, -top / 4, top / 2], np.float32)
        gj = np.asarray(jax.grad(jax_scale)(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        st = torch_scale(xt)
        gt, = torch.autograd.grad(st, xt)
        np.testing.assert_array_equal(st.detach().numpy(), np.asarray(jax_scale(jnp.asarray(x))))
        np.testing.assert_array_equal(gt.numpy(), gj)
        if top == np.float32(1e-5):
            assert gt[0].item() == np.float32(0.5) / np.float32(127)
