"""K1 (quant_w8a8_matmul_qout) and K2 (quant_w8a8_matmul_q8): the plain
PyTorch versions against the JAX Pallas kernels run in interpret mode on
the CPU, as tests/test_pallas_kernels.py runs them.

XLA compiles the interpreted kernel, and on the CPU it turns ``/ 127`` into a
multiply by the reciprocal and contracts ``acc * s + b`` into an FMA; the
port divides exactly and never contracts (as its CUDA kernels do).  So K2's
int8 rows are bit-equal and its scales agree within rtol 1e-6, and K1
agrees within atol 1e-4 / rtol 1e-5 (tests/test_stacked_decode.py:99).
Against the JAX package's eager int8 chain, which also divides exactly,
both are bit-equal.  The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.ops.pallas.w8a8_matmul import (
    quant_w8a8_matmul_q8 as jax_q8,
    quant_w8a8_matmul_qout as jax_qout,
)
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K

SHAPES = [(3, 16, 64, 96), (1, 37, 64, 96)]   # the JAX test's shape, a ragged M


def _case(b, s, k, n, seed=17):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sw = rng.uniform(0.001, 0.01, (n,)).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    return x, wq, sw, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_q8_ref_matches_jax_interpret(shape):
    x, wq, sw, bias = _case(*shape)
    qj, sj = jax_q8(*map(jnp.asarray, (x, wq, sw, bias)))
    qt, st = K.quant_w8a8_matmul_q8_ref(*_t(x.reshape(-1, x.shape[-1]), wq, sw, bias))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj).reshape(qt.shape))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj).reshape(st.shape), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_qout_ref_matches_jax_interpret(shape):
    x, wq, sw, bias = _case(*shape)
    yj = jax_qout(*map(jnp.asarray, (x, wq, sw, bias)))
    yt = K.quant_w8a8_matmul_qout_ref(*_t(x.reshape(-1, x.shape[-1]), wq, sw, bias))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj).reshape(yt.shape),
                               atol=1e-4, rtol=1e-5)


def test_refs_bit_equal_to_jax_eager_chain():
    """At the encoder's widths, against the JAX int8 chain run eagerly."""
    x, wq, sw, bias = _case(1, 200, 512, 512, seed=3)
    lin = JW.make_w8a8_linear_impl({"p.linears.0": {"wq": jnp.asarray(wq), "sw": jnp.asarray(sw),
                                                    "b": jnp.asarray(bias)}}, mode="int8")
    y_chain = np.asarray(lin("p.linears.0", jnp.asarray(x[0]), None, None))
    x2, wq_t, sw_t, b_t = _t(x[0], wq, sw, bias)
    np.testing.assert_array_equal(K.quant_w8a8_matmul_qout_ref(x2, wq_t, sw_t, b_t).numpy(),
                                  y_chain)
    qt, st = K.quant_w8a8_matmul_q8_ref(x2, wq_t, sw_t, b_t)
    np.testing.assert_array_equal((qt.float() * st).numpy(), y_chain)


def test_cpu_dispatch_takes_plain_version():
    x, wq, sw, bias = _case(3, 16, 64, 96)
    xt, wt, swt, bt = _t(x, wq, sw, bias)
    n1, n2 = K.quant_w8a8_matmul_qout.launches, K.quant_w8a8_matmul_q8.launches
    y = K.quant_w8a8_matmul_qout(xt, wt, swt, bt)
    q, s = K.quant_w8a8_matmul_q8(xt, wt, swt, bt)
    assert y.shape == (3, 16, 96) and q.shape == (3, 16, 96) and s.shape == (3, 16, 1)
    assert q.dtype == torch.int8
    x2 = xt.reshape(-1, 64)
    assert torch.equal(y.reshape(-1, 96), K.quant_w8a8_matmul_qout_ref(x2, wt, swt, bt))
    q_ref, s_ref = K.quant_w8a8_matmul_q8_ref(x2, wt, swt, bt)
    assert torch.equal(q.reshape(-1, 96), q_ref) and torch.equal(s.reshape(-1, 1), s_ref)
    # no kernel ran, so nothing was counted
    assert (K.quant_w8a8_matmul_qout.launches, K.quant_w8a8_matmul_q8.launches) == (n1, n2)
    # a missing bias is zero
    assert torch.equal(K.quant_w8a8_matmul_qout(xt, wt, swt),
                       K.quant_w8a8_matmul_qout(xt, wt, swt, torch.zeros(96)))


@pytest.mark.parametrize("bad", ["k_too_big", "n_too_big", "x_dtype", "w_dtype", "sw_shape"])
def test_wrappers_reject_bad_inputs(bad):
    k, n = (4096, 8) if bad == "k_too_big" else (8, 4096) if bad == "n_too_big" else (64, 96)
    x = torch.zeros(4, k, dtype=torch.float64 if bad == "x_dtype" else torch.float32)
    wq = torch.zeros(k, n, dtype=torch.int32 if bad == "w_dtype" else torch.int8)
    sw = torch.ones(n + (1 if bad == "sw_shape" else 0))
    for fn in (K.quant_w8a8_matmul_qout, K.quant_w8a8_matmul_q8):
        with pytest.raises(ValueError):
            fn(x, wq, sw)


@pytest.mark.parametrize("m,k,n", [(5, 64, 96), (40, 24, 8)])
def test_int_mm_exact(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = K.int_mm(*_t(a, b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
