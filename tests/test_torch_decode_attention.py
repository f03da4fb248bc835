"""K3 (decode_attention_int8): the port's plain versions against the JAX
Pallas kernel run in interpret mode on the CPU and against the JAX oracle,
as tests/test_pallas_kernels.py:86-118 runs them, at that test's bound
(rtol 1e-5, atol 1e-4).  The plain version follows the CUDA kernel's
contract (scale after the dot, probabilities rounded as round(p*127)/127);
the kernel itself is held against it on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.ops.pallas.attention import (
    decode_attention_int8 as jax_kernel,
    decode_attention_int8_oracle as jax_oracle,
)
from onnx_transformer_tpu_torch.ops.kernels import decode_attention as K

TOL = dict(rtol=1e-5, atol=1e-4)


def _case(b=5, t=72, d=512, seed=0, masked_row=None):
    """Merged-head int8 cache [B, T, D] with per-token scales and ragged
    per-row visibility (tests/test_pallas_kernels.py:88-99)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    kq = rng.integers(-127, 128, (b, t, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, t, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (b, t)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (b, t)).astype(np.float32)
    lens = rng.integers(1, t + 1, b)
    mask = np.arange(t)[None, :] < lens[:, None]
    if masked_row is not None:
        mask[masked_row] = False
    return q, kq, ks, vq, vs, mask


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("quantize", [True, False])
def test_ref_matches_jax_kernel_and_oracle(quantize):
    args = _case()
    want_k = np.asarray(jax_kernel(*map(jnp.asarray, args), num_heads=8, quantize=quantize,
                                   interpret=True))
    want_o = np.asarray(jax_oracle(*map(jnp.asarray, args), num_heads=8, quantize=quantize))
    got = K.decode_attention_int8_ref(*_torch(args), num_heads=8, quantize=quantize)
    assert got.shape == (5, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_k, **TOL)
    np.testing.assert_allclose(got.numpy(), want_o, **TOL)
    oracle = K.decode_attention_int8_oracle(*_torch(args), num_heads=8, quantize=quantize)
    np.testing.assert_allclose(oracle.numpy(), want_o, **TOL)


def test_block_padding_b3():
    """B=3 is not a multiple of the JAX kernel's block_b=8 (its pad path);
    the port has no block."""
    args = _case(b=3)
    want = np.asarray(jax_kernel(*map(jnp.asarray, args), num_heads=8, block_b=8,
                                 interpret=True))
    got = K.decode_attention_int8_ref(*_torch(args), num_heads=8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_oracle(*map(jnp.asarray, args),
                                                                  num_heads=8)), **TOL)


@pytest.mark.parametrize("quantize", [True, False])
def test_fully_masked_row_is_uniform(quantize):
    """A row with no visible position: every score is -1e9, so the softmax
    is uniform over T, not NaN."""
    args = _case(b=4, t=16, d=64, seed=3, masked_row=2)
    got = K.decode_attention_int8_ref(*_torch(args), num_heads=4, quantize=quantize)
    assert torch.isfinite(got).all()
    want = np.asarray(jax_kernel(*map(jnp.asarray, args), num_heads=4, quantize=quantize,
                                 interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _, _, _, vq, vs, _ = args
    p = np.float32(1.0 / 16)
    if quantize:
        p = np.float32(np.round(p * 127) / 127)
    uniform = (p * (vq[2].astype(np.float32) * vs[2][:, None])).sum(0)
    np.testing.assert_allclose(got[2].numpy(), uniform, **TOL)


@pytest.mark.parametrize("b,t,d,h", [(3, 1, 512, 8), (2, 9, 18, 3), (1, 5, 10, 5)])
def test_odd_shapes_match_oracle(b, t, d, h):
    """T=1, and heads whose width is not a multiple of 4 (dk = 6, 2: the
    kernel reads those by bytes)."""
    args = _case(b=b, t=t, d=d, seed=b + t)
    want = np.asarray(jax_oracle(*map(jnp.asarray, args), num_heads=h))
    got = K.decode_attention_int8_ref(*_torch(args), num_heads=h)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_dispatch_takes_plain_version():
    args = _torch(_case(b=3, t=10, d=64, seed=4))
    n = K.decode_attention_int8.launches
    got = K.decode_attention_int8(*args, num_heads=4)
    assert torch.equal(got, K.decode_attention_int8_ref(*args, num_heads=4))
    assert K.decode_attention_int8.launches == n


@pytest.mark.parametrize("bad", ["heads", "dk", "q_shape", "kq_dtype", "ks_dtype", "mask"])
def test_wrapper_rejects_bad_inputs(bad):
    b, t, d, h = 2, 4, 64, 4
    if bad == "heads":
        h = 5
    if bad == "dk":
        d, h = 256, 1
    q, kq, ks, vq, vs, mask = _torch(_case(b=b, t=t, d=d))
    if bad == "q_shape":
        q = q[:, :-1]
    if bad == "kq_dtype":
        kq = kq.int()
    if bad == "ks_dtype":
        ks = ks.double()
    if bad == "mask":
        mask = mask[:, :-1]
    with pytest.raises(ValueError):
        K.decode_attention_int8(q, kq, ks, vq, vs, mask, num_heads=h)


@pytest.mark.parametrize("t,d,h", [(72, 512, 8), (1, 512, 8), (1024, 512, 8), (9, 18, 3),
                                   (72, 1024, 8), (33, 256, 16), (16384, 512, 8),
                                   (16384, 1024, 8), (5, 10, 5)])
def test_head_group_plan(t, d, h):
    """K3's heads per CTA: a divisor of H, a row slice of at most 512 bytes
    (one 16-byte load per lane of a warp), scores and partial sums within
    the shared-memory cap; the grid's B x H/hg CTAs then cover every head of
    every sequence once."""
    hg = K.plan_decode_attention(t, d, h)
    dk = d // h
    assert h % hg == 0 and hg * dk <= K.MAX_GROUP_BYTES
    partial = K.WARPS * hg * dk if dk in (16, 32, 64, 128) else 0
    assert 4 * (-(-hg * t // 4) * 4 + partial) <= K.MAX_SMEM
    heads = np.zeros(h, np.int32)
    for y in range(h // hg):
        heads[y * hg:(y + 1) * hg] += 1
    assert (heads == 1).all()


def test_head_group_plan_serving_shape_is_one_cta_per_sequence():
    """At B=512 T=72 D=512 H=8 all eight heads share a CTA: 512 CTAs of 256
    threads, each streaming whole 512-byte rows."""
    assert K.plan_decode_attention(72, 512, 8) == 8
    assert K.plan_decode_attention(72, 1024, 8) == 4    # 128-byte heads: 512 bytes a CTA


def test_head_group_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError):
        K.plan_decode_attention(60000, 1024, 8)
