"""K1 (quant_w8a8_matmul_qout), K2 (quant_w8a8_matmul_q8) and K5
(w8a8_matmul): the plain PyTorch versions against the JAX Pallas kernels
run in interpret mode on the CPU, as tests/test_pallas_kernels.py runs them.

XLA compiles the interpreted kernel, and on the CPU it turns ``/ 127`` into a
multiply by the reciprocal and contracts ``acc * s + b`` into an FMA; the
port divides exactly and never contracts (as its CUDA kernels do).  So K2's
int8 rows are bit-equal and its scales agree within rtol 1e-6, and K1
agrees within atol 1e-4 / rtol 1e-5 (tests/test_stacked_decode.py:99).
Against the JAX package's eager int8 chain, which also divides exactly,
both are bit-equal.  K5's plain version agrees with its interpreted JAX
kernel within that test's rtol 1e-6 / atol 1e-4 and is bit-equal to the
eager JAX int8 chain.  The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py; K5's tile planner, which
chooses the kernel's grid from the shape, is tested here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.ops.pallas.w8a8_matmul import (
    quant_w8a8_matmul_q8 as jax_q8,
    quant_w8a8_matmul_qout as jax_qout,
    w8a8_matmul as jax_w8a8,
)
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K
from onnx_transformer_tpu_torch.quant import core as Q

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


def _k5_case(m, k, n, seed=0):
    """Pre-quantized operands as tests/test_pallas_kernels.py:13-25 makes
    them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    sw = (np.abs(w).max(0) / 127).astype(np.float32)
    wq = np.round(w / sw).astype(np.int8)
    sx = (np.abs(x).max(-1) / 127).astype(np.float32)
    xq = np.round(x / sx[:, None]).astype(np.int8)
    bias = rng.normal(size=n).astype(np.float32)
    return xq, sx, wq, sw, bias


@pytest.mark.parametrize("m,k,n,lead,block_k", [
    (64, 128, 128, None, 2048), (100, 512, 256, None, 2048), (8, 256, 512, None, 2048),
    (60, 128, 128, (4, 15), 2048),                      # lead dims
    (64, 512, 256, None, 128), (64, 384, 256, None, 128),
    (64, 300, 256, None, 128),                          # K-tiled, ragged last K tile
])
def test_k5_ref_matches_jax_interpret(m, k, n, lead, block_k):
    xq, sx, wq, sw, bias = _k5_case(m, k, n)
    if lead is not None:
        xq, sx = xq.reshape(*lead, k), sx.reshape(lead)
    want = np.asarray(jax_w8a8(*map(jnp.asarray, (xq, sx, wq, sw, bias)), block_k=block_k,
                               interpret=True))
    got = K.w8a8_matmul(*_t(xq, sx, wq, sw, bias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_k5_no_bias():
    xq, sx, wq, sw, bias = _k5_case(16, 128, 128)
    want = np.asarray(jax_w8a8(*map(jnp.asarray, (xq, sx, wq, sw)), None, interpret=True))
    got = K.w8a8_matmul(*_t(xq, sx, wq, sw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    assert torch.equal(got, K.w8a8_matmul(*_t(xq, sx, wq, sw, np.zeros(128, np.float32))))


@pytest.mark.parametrize("m,k,n", [(200, 512, 512), (1, 300, 96)])
def test_k5_ref_bit_equal_to_jax_eager_chain(m, k, n):
    """Against the JAX package's "int8" linear run eagerly, fed the same
    activations: the int8 rows and scales it computes go to K5."""
    x = np.random.default_rng(m).normal(size=(m, k)).astype(np.float32)
    _, _, wq, sw, bias = _k5_case(m, k, n, seed=1)
    lin = JW.make_w8a8_linear_impl({"p.w_1": {"wq": jnp.asarray(wq), "sw": jnp.asarray(sw),
                                              "b": jnp.asarray(bias)}}, mode="int8")
    want = np.asarray(lin("p.w_1", jnp.asarray(x), None, None))
    xt = torch.from_numpy(x)
    sx = Q.act_scale_per_token(xt)
    got = K.w8a8_matmul(Q.quantize(xt, sx), sx[:, 0], *_t(wq, sw, bias))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k5_cpu_dispatch_and_edges():
    """M=1 and lead dims take the plain version on the CPU; nothing is
    counted; the plain version's product is exact."""
    xq, sx, wq, sw, bias = _k5_case(60, 300, 96, seed=5)
    n = K.w8a8_matmul.launches
    one = K.w8a8_matmul(*_t(xq[:1], sx[:1], wq, sw, bias))
    assert one.shape == (1, 96)
    acc = xq[:1].astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_allclose(one.numpy(), acc * (sx[:1, None] * sw) + bias, rtol=1e-6,
                               atol=1e-4)
    lead = K.w8a8_matmul(*_t(xq.reshape(4, 15, 300), sx.reshape(4, 15), wq, sw, bias))
    assert lead.shape == (4, 15, 96)
    assert torch.equal(lead.reshape(60, 96),
                       K.w8a8_matmul_ref(*_t(xq, sx, wq, sw, bias)))
    assert K.w8a8_matmul.launches == n


@pytest.mark.parametrize("bad", ["xq_dtype", "sx_shape", "sx_dtype", "wq_k", "b_shape"])
def test_k5_rejects_bad_inputs(bad):
    xq = torch.zeros(4, 64, dtype=torch.float32 if bad == "xq_dtype" else torch.int8)
    sx = torch.ones(5 if bad == "sx_shape" else 4,
                    dtype=torch.float64 if bad == "sx_dtype" else torch.float32)
    wq = torch.zeros(63 if bad == "wq_k" else 64, 96, dtype=torch.int8)
    b = torch.zeros(97 if bad == "b_shape" else 96)
    with pytest.raises(ValueError):
        K.w8a8_matmul(xq, sx, wq, torch.ones(96), b)


# K5's six shapes on the serving path ([M, K, N]): the decode step's three,
# then the prefill's three
K5_SERVING_SHAPES = [(512, 512, 512), (512, 512, 2048), (512, 2048, 512),
                     (36864, 512, 512), (36864, 512, 2048), (36864, 2048, 512)]


@pytest.mark.parametrize("m,k,n", K5_SERVING_SHAPES + [
    (1000, 512, 96), (129, 304, 200), (1, 300, 96), (60, 128, 128), (37, 17, 5)])
def test_k5_tile_plan_covers_every_output_once(m, k, n):
    """The planner's grid (blockIdx.x over M, blockIdx.y over N, each CTA a
    BM x BN tile masked at the edges) covers every output element exactly
    once: at the serving shapes, at ragged M/K/N, M = 1 and lead dims (4, 15)
    flattened to M = 60.  K does not enter the plan: every CTA walks all of
    it.  The tiles form a grid, so each axis is checked on its own."""
    tile, grid_m, grid_n = K.plan_w8a8_tile(m, n)
    bm, bn = K.W8A8_TILES[tile]
    assert (grid_m, grid_n) == (-(-m // bm), -(-n // bn))
    for size, block, blocks in ((m, bm, grid_m), (n, bn, grid_n)):
        cover = np.zeros(size, np.int32)
        for i in range(blocks):
            cover[i * block:min((i + 1) * block, size)] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("m,k,n", K5_SERVING_SHAPES)
def test_k5_tile_plan_fills_the_card(m, k, n):
    """Every serving shape gets at least 128 CTAs for the H100's 132 SMs
    (the planner aims at 256): 32x32 or 64x64 tiles at the decode step's 512
    rows, 128x128 at the prefill's 36,864."""
    tile, grid_m, grid_n = K.plan_w8a8_tile(m, n)
    assert grid_m * grid_n >= max(128, K.W8A8_MIN_CTAS)
    assert K.W8A8_TILES[tile] == ((128, 128) if m == 36864 else (32, 32) if n == 512
                                  else (64, 64))


def test_k5_tile_plan_small_products_take_the_smallest_tile():
    assert K.plan_w8a8_tile(1, 96) == (len(K.W8A8_TILES) - 1, 1, 3)


# K1/K2's configuration planner (csrc/w8a8_qrows.cu): K and N on a grid up
# to MAX_KN = 2048, ragged values among them
QROWS_K = [16, 64, 300, 304, 512, 1024, 1344, 1345, 1408, 2000, 2048]
QROWS_N = [8, 96, 200, 512, 513, 1000, 1024, 1025, 1536, 2048]


def _qrows_tile(tile):
    """(BM, chunk, chunks, warps along M, warps along N, warp rows, warp
    columns) of a configuration."""
    bm, bn, ch, warps_m = K.QROWS_TILES[tile]
    warps_n = K.QROWS_WARPS // warps_m
    return bm, bn, ch, warps_m, warps_n, bm // warps_m, bn // warps_n


@pytest.mark.parametrize("k", QROWS_K)
@pytest.mark.parametrize("n", QROWS_N)
def test_qrows_plan_covers_every_output_once(k, n):
    """The kernel's map from (CTA, warp, mma fragment) to output elements
    covers every row of M and every column of N exactly once, at M = 1, a
    ragged M and the main path's 36,864 rows.  A CTA holds BM rows of all N
    columns; its warps split BM into warps_m blocks of 16-row mma tiles and
    each 512-column chunk into warps_n blocks of n8 tiles; a lane holds rows
    g and g + 8 and columns 2t and 2t + 1 of each 16x8 tile."""
    for m in (1, 129, 36864):
        tile, smem, ctas = K.plan_w8a8_qrows(m, k, n)
        bm, bn, ch, warps_m, warps_n, wm, wn = _qrows_tile(tile)
        assert ctas == -(-m // bm)
        rows = np.zeros(ctas * bm, np.int32)
        for cta in range(ctas):
            for w in range(warps_m):
                for mi in range(wm // 16):
                    for g in range(8):
                        for h in range(2):
                            rows[cta * bm + w * wm + mi * 16 + g + h * 8] += 1
        assert (rows == 1).all() and len(rows) >= m
        cols = np.zeros(ch * bn, np.int32)
        for c in range(ch):
            for w in range(warps_n):
                for ni in range(wn // 8):
                    for t in range(4):
                        cols[c * bn + w * wn + ni * 8 + 2 * t] += 1
                        cols[c * bn + w * wn + ni * 8 + 2 * t + 1] += 1
        assert (cols == 1).all() and len(cols) >= n


@pytest.mark.parametrize("n", QROWS_N)
def test_qrows_plan_shared_memory_fits(n):
    """At every K up to 2048 the planned shared memory fits the H100's
    232,448 bytes per block, is the configuration's own, is a multiple of
    16 bytes, and holds the resident int8 x rows and the W ring, and (in
    the same bytes, after the loop) the f32 output staging."""
    for k in range(1, K.MAX_KN + 1):
        tile, smem, _ = K.plan_w8a8_qrows(7, k, n)
        bm, bn, ch, *_ = K.QROWS_TILES[tile]
        assert smem == K.qrows_smem(tile, k) <= K.MAX_SMEM
        assert smem % 16 == 0
        assert n <= bn * ch
        assert smem >= max(bm * k + K.QROWS_STAGES * 64 * bn, bm * n * 4)


def test_qrows_tiles_register_budget_and_bm():
    """Every configuration: BM a multiple of 16, 16 warps, and at most 64
    int32 sums a thread (BM x N capacity <= 32,768)."""
    for tile, (bm, bn, ch, warps_m) in enumerate(K.QROWS_TILES):
        assert bm % 16 == 0 and K.QROWS_WARPS % warps_m == 0
        _, _, _, _, _, wm, wn = _qrows_tile(tile)
        assert wm % 16 == 0 and wn % 16 == 0
        assert bm * bn * ch <= 32768


def test_qrows_plan_main_shape():
    """At the main path's [36864,512] x [512,512]: BM = 64 rows of 512
    columns, 64 sums a thread, 576 CTAs of 178,432 bytes (one per SM)."""
    tile, smem, ctas = K.plan_w8a8_qrows(36864, 512, 512)
    bm, bn, ch, _ = K.QROWS_TILES[tile]
    assert (bm, bn * ch, ctas, smem) == (64, 512, 576, 178432)
    assert bm * 512 // (K.QROWS_WARPS * 32) == 64
    assert 2 * smem > K.MAX_SMEM


@pytest.mark.parametrize("m,k,n,bm", [(64, 2048, 512, 32), (64, 512, 2048, 16),
                                      (32, 2048, 2048, 16), (64, 1344, 512, 64),
                                      (64, 1345, 512, 32), (64, 512, 1024, 32)])
def test_qrows_plan_corners(m, k, n, bm):
    """The MAX_KN corners, where the planner lowers BM to keep the int8 x
    rows or the sums within the card."""
    tile, _, ctas = K.plan_w8a8_qrows(m, k, n)
    assert K.QROWS_TILES[tile][0] == bm and ctas == -(-m // bm)


@pytest.mark.parametrize("k,n", [(0, 8), (8, 0), (2049, 8), (8, 2049)])
def test_qrows_plan_rejects_out_of_range(k, n):
    with pytest.raises(ValueError):
        K.plan_w8a8_qrows(4, k, n)


@pytest.mark.parametrize("lead,k,n", [((1,), 300, 96), ((4, 15), 128, 128),
                                      ((129,), 304, 200), ((64,), 2048, 512),
                                      ((64,), 512, 2048), ((32,), 2048, 2048)])
def test_qrows_new_shapes_cpu_dispatch(lead, k, n):
    """The card check's new K1/K2 shapes through the wrappers on the CPU:
    the plain versions, unchanged, and nothing counted."""
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sw = rng.uniform(0.001, 0.01, (n,)).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    xt, wt, swt, bt = _t(x, wq, sw, bias)
    before = (K.quant_w8a8_matmul_qout.launches, K.quant_w8a8_matmul_q8.launches)
    y = K.quant_w8a8_matmul_qout(xt, wt, swt, bt)
    q, s = K.quant_w8a8_matmul_q8(xt, wt, swt, bt)
    assert y.shape == (*lead, n) and q.shape == (*lead, n) and s.shape == (*lead, 1)
    x2 = xt.reshape(-1, k)
    assert torch.equal(y.reshape(-1, n), K.quant_w8a8_matmul_qout_ref(x2, wt, swt, bt))
    q_ref, s_ref = K.quant_w8a8_matmul_q8_ref(x2, wt, swt, bt)
    assert torch.equal(q.reshape(-1, n), q_ref) and torch.equal(s.reshape(-1, 1), s_ref)
    # the f32 output lies on the int8 grid of its row scale
    assert torch.equal(y.reshape(-1, n), q_ref.float() * s_ref)
    assert (K.quant_w8a8_matmul_qout.launches, K.quant_w8a8_matmul_q8.launches) == before
