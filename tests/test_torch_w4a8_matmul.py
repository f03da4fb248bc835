"""K6 (quant_w4a8_matmul_qout), K7 (quant_w4a8_matmul_q8), K8
(quant_w4a8_matmul) and K4 (quant_w8a8_matmul): the plain PyTorch versions
against the JAX Pallas kernels run in interpret mode on the CPU, at the JAX
tests' shapes and bounds (tests/test_pallas_kernels.py:49,143,162,186,279,
tests/test_quant.py:321): rtol 1e-6 / atol 1e-4 for K4 and K8 (the
interpreted kernels contract ``acc * s + b`` into an FMA on the CPU),
atol 1e-4 / rtol 1e-5 for K6, and K7's int8 rows equal with scales within
rtol 1e-6.  Against the JAX package's eager chain, which divides exactly
and does not contract, each is bit-equal.  The wrappers' argument checks,
and their CPU dispatch to the plain versions; K6/K7's configuration planner
(``plan_w8a8_qrows`` with ``packed=True``).  The CUDA kernels themselves
are held against these plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.ops.pallas import w8a8_matmul as JK
from onnx_transformer_tpu.quant import core as JQ
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as K


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _case(m, k, n, seed, int4=False, scale=1.0, bias=True):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * scale).astype(np.float32)
    lo, hi = (-8, 8) if int4 else (-127, 128)
    wq = rng.integers(lo, hi, (k, n)).astype(np.int8)
    sw = rng.uniform(0.001, 0.01, (n,)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    return x, wq, sw, b


def _eager_chain(x, wq, sw, b):
    """The JAX package's per-token quantize + int32 product + epilogue, op
    by op."""
    xq, sx = JQ.quantize_act_per_token(jnp.asarray(x))
    acc = jax.lax.dot_general(xq, jnp.asarray(wq), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (sx * jnp.asarray(sw)[None, :])
    return np.asarray(y + jnp.asarray(b) if b is not None else y)


@pytest.mark.parametrize("m,k,n,seed,block_k,bias,scale", [
    (32, 256, 128, 0, 2048, True, 1.0),           # test_pallas_kernels.py:49
    (16, 10240, 128, 0, 2048, True, 1.0),         # :143, K past the one-block limit
    (24, 16384, 96, 11, 4096, True, 3.0),         # :162, the K-tiled kernel
    (16, 9728, 64, 13, 4096, False, 1.0),         # :186, ragged last K tile, no bias
])
def test_k4_ref_matches_jax_interpret(m, k, n, seed, block_k, bias, scale):
    x, wq, sw, b = _case(m, k, n, seed, scale=scale, bias=bias)
    want = np.asarray(JK.quant_w8a8_matmul(*map(jnp.asarray, (x, wq, sw)),
                                           None if b is None else jnp.asarray(b),
                                           block_k=block_k, interpret=True))
    bt = torch.zeros(n) if b is None else _t(b)[0]
    got = K.quant_w8a8_matmul_ref(*_t(x, wq, sw), bt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), _eager_chain(x, wq, sw, b))
    # the wrapper takes the plain version on the CPU
    assert torch.equal(K.quant_w8a8_matmul(*_t(x, wq, sw), None if b is None else bt), got)


@pytest.mark.parametrize("m,k,n,seed", [(24, 32, 64, 3),    # test_quant.py:321
                                        (24, 64, 96, 23),   # test_pallas_kernels.py:279
                                        (40, 300, 96, 5)])  # ragged K, any N
def test_k8_ref_matches_jax_interpret(m, k, n, seed):
    x, wq, sw, b = _case(m, k, n, seed, int4=True)
    packed = np.asarray(JQ.pack_int4(jnp.asarray(wq)))
    got = K.quant_w4a8_matmul_ref(*_t(x, packed, sw, b))
    if n % min(512, n) == 0:
        want = np.asarray(JK.quant_w4a8_matmul(*map(jnp.asarray, (x, packed, sw, b)),
                                               interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), _eager_chain(x, wq, sw, b))
    assert torch.equal(got, K.quant_w8a8_matmul_ref(*_t(x, wq, sw, b)))


@pytest.mark.parametrize("m,k,n,seed", [(24, 64, 96, 23), (37, 128, 256, 4)])
def test_k6_k7_refs_match_jax_interpret(m, k, n, seed):
    """As tests/test_pallas_kernels.py:279-303: K6 against its interpreted
    kernel and the fake-quant of the eager chain; K7's rows and scales."""
    x, wq, sw, b = _case(m, k, n, seed, int4=True)
    packed = np.asarray(JQ.pack_int4(jnp.asarray(wq)))
    args_j = list(map(jnp.asarray, (x, packed, sw, b)))
    x2, pt, swt, bt = _t(x, packed, sw, b)
    y = K.quant_w4a8_matmul_qout_ref(x2, pt, swt, bt)
    np.testing.assert_allclose(y.numpy(), np.asarray(JK.quant_w4a8_matmul_qout(
        *args_j, interpret=True)), atol=1e-4, rtol=1e-5)
    chain_q = np.asarray(JQ.fake_quant_act_per_token(jnp.asarray(_eager_chain(x, wq, sw, b))))
    np.testing.assert_array_equal(y.numpy(), chain_q)
    q, s = K.quant_w4a8_matmul_q8_ref(x2, pt, swt, bt)
    qj, sj = JK.quant_w4a8_matmul_q8(*args_j, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    np.testing.assert_array_equal((q.float() * s).numpy(), chain_q)


def test_cpu_dispatch_lead_dims_and_counts():
    """Lead dims and a missing bias on the CPU: the plain versions, nothing
    counted."""
    x, wq, sw, b = _case(60, 128, 96, 7, int4=True)
    xt, wt, swt, bt = _t(x.reshape(4, 15, 128), wq, sw, b)
    pt = torch.from_numpy(np.array(JQ.pack_int4(jnp.asarray(wq))))
    fns = (K.quant_w4a8_matmul_qout, K.quant_w4a8_matmul_q8, K.quant_w4a8_matmul,
           K.quant_w8a8_matmul)
    counts = [f.launches for f in fns]
    y6 = K.quant_w4a8_matmul_qout(xt, pt, swt, bt)
    q7, s7 = K.quant_w4a8_matmul_q8(xt, pt, swt, bt)
    y8 = K.quant_w4a8_matmul(xt, pt, swt)
    y4 = K.quant_w8a8_matmul(xt, wt, swt)
    assert y6.shape == y8.shape == y4.shape == q7.shape == (4, 15, 96)
    assert s7.shape == (4, 15, 1) and q7.dtype == torch.int8
    x2 = xt.reshape(60, 128)
    assert torch.equal(y6.reshape(60, 96), K.quant_w4a8_matmul_qout_ref(x2, pt, swt, bt))
    assert torch.equal(y8, y4) and torch.equal(
        y8.reshape(60, 96), K.quant_w4a8_matmul_ref(x2, pt, swt, torch.zeros(96)))
    assert [f.launches for f in fns] == counts


def _raises(fn, x, w, sw=None, b=None):
    with pytest.raises(ValueError):
        fn(x, w, torch.ones(w.shape[1]) if sw is None else sw, b)


def test_wrappers_reject_bad_inputs():
    p = torch.zeros(32, 96, dtype=torch.uint8)
    w8 = torch.zeros(64, 96, dtype=torch.int8)
    x = torch.zeros(4, 64)
    # K or N over 2048 for K6/K7 (the kernels' own limit)
    for fn in (K.quant_w4a8_matmul_qout, K.quant_w4a8_matmul_q8):
        _raises(fn, torch.zeros(2, 4096), torch.zeros(2048, 8, dtype=torch.uint8))
        _raises(fn, x, torch.zeros(32, 4096, dtype=torch.uint8))
    # K8: odd K, and K over 4096; N is free
    _raises(K.quant_w4a8_matmul, torch.zeros(2, 301), torch.zeros(150, 8, dtype=torch.uint8))
    _raises(K.quant_w4a8_matmul, torch.zeros(2, 8192), torch.zeros(4096, 8, dtype=torch.uint8))
    assert K.quant_w4a8_matmul(torch.zeros(2, 64), torch.zeros(32, 5000, dtype=torch.uint8),
                               torch.ones(5000)).shape == (2, 5000)
    # the uint8 / int8 mix-up, both ways
    for fn in (K.quant_w4a8_matmul_qout, K.quant_w4a8_matmul_q8, K.quant_w4a8_matmul):
        _raises(fn, x, torch.zeros(32, 96, dtype=torch.int8))
        _raises(fn, x, w8)                      # int8 [K, N] passed as packed
    for fn in (K.quant_w8a8_matmul, K.quant_w8a8_matmul_qout, K.quant_w8a8_matmul_q8):
        _raises(fn, x, torch.zeros(64, 96, dtype=torch.uint8))
    # a non-contiguous weight operand, scale or bias
    wide = torch.zeros(96, 32, dtype=torch.uint8).t()
    assert wide.shape == (32, 96) and not wide.is_contiguous()
    for fn in (K.quant_w4a8_matmul_qout, K.quant_w4a8_matmul_q8, K.quant_w4a8_matmul):
        _raises(fn, x, wide)
        _raises(fn, x, p, sw=torch.ones(96, 2)[:, 0])
        _raises(fn, x, p, b=torch.zeros(96, 2)[:, 0])
    _raises(K.quant_w8a8_matmul, x, torch.zeros(96, 64, dtype=torch.int8).t())
    # f32 input only; scales and bias f32 [N]
    _raises(K.quant_w8a8_matmul, x.double(), w8)
    _raises(K.quant_w4a8_matmul, x, p, sw=torch.ones(95))


# K6/K7's configuration planner (csrc/w4a8_qrows.cu over csrc/qrows.cuh):
# the K x N grid of K1/K2's planner tests (tests/test_torch_w8a8_matmul.py),
# even K only
PACKED_K = [16, 64, 300, 304, 512, 1024, 1344, 1408, 2000, 2048]
PACKED_N = [8, 96, 200, 512, 513, 1000, 1024, 1025, 1536, 2048]


@pytest.mark.parametrize("k", PACKED_K)
@pytest.mark.parametrize("n", PACKED_N)
def test_packed_qrows_plan_covers_every_output_once(k, n):
    """As K1/K2's planner test: the map from (CTA, warp, mma fragment) to
    output elements covers every row of M and every column of N exactly
    once, at M = 1, a ragged M and the int4 path's 36,864 rows; and the
    packed plan never takes tile 1, which K6/K7 do not build."""
    for m in (1, 129, 36864):
        tile, smem, ctas = K.plan_w8a8_qrows(m, k, n, packed=True)
        bm, bn, ch, warps_m = K.QROWS_TILES[tile]
        warps_n = K.QROWS_WARPS // warps_m
        wm, wn = bm // warps_m, bn // warps_n
        assert tile != 1 and ctas == -(-m // bm)
        # a row: CTA, warp along M, 16-row mma tile, g, g + 8
        rows = (np.arange(ctas)[:, None, None, None, None] * bm
                + np.arange(warps_m)[:, None, None, None] * wm
                + np.arange(wm // 16)[:, None, None] * 16
                + np.arange(8)[:, None] + np.arange(2) * 8).ravel()
        assert np.array_equal(np.sort(rows), np.arange(ctas * bm)) and ctas * bm >= m
        # a column: chunk, warp along N, n8 tile, 2t, 2t + 1
        cols = (np.arange(ch)[:, None, None, None, None] * bn
                + np.arange(warps_n)[:, None, None, None] * wn
                + np.arange(wn // 8)[:, None, None] * 8
                + np.arange(4)[:, None] * 2 + np.arange(2)).ravel()
        assert np.array_equal(np.sort(cols), np.arange(ch * bn)) and ch * bn >= n


@pytest.mark.parametrize("n", PACKED_N)
def test_packed_qrows_shared_memory_fits(n):
    """At every even K up to 2048 the packed plan's shared memory fits the
    H100's 232,448 bytes per block, is the configuration's own, holds the
    resident int8 x rows, the ring of 32-row packed W tiles and the f32
    output staging; and no configuration takes more with packed W than
    with int8 W."""
    for k in range(2, K.MAX_KN + 1, 2):
        tile, smem, _ = K.plan_w8a8_qrows(7, k, n, packed=True)
        bm, bn, ch, _ = K.QROWS_TILES[tile]
        assert smem == K.qrows_smem(tile, k, packed=True) <= K.MAX_SMEM
        assert smem % 16 == 0 and n <= bn * ch
        assert smem >= max(bm * k + K.QROWS_STAGES * 32 * bn, bm * n * 4)
        for t in range(len(K.QROWS_TILES)):
            assert K.qrows_smem(t, k, packed=True) < K.qrows_smem(t, k)


def test_packed_qrows_plan_main_shape():
    """At the int4 path's [36864,512] x [512,512]: tile 0 (BM = 64 rows of
    512 columns), 576 CTAs of 135,424 bytes (one per SM), against K1's
    178,432: the f32 output staging [64, 520] now outweighs the loop's
    buffers."""
    tile, smem, ctas = K.plan_w8a8_qrows(36864, 512, 512, packed=True)
    assert (tile, ctas, smem) == (0, 576, 135424)
    assert smem == 2304 + 64 * 520 * 4 > 2304 + 64 * 528 + 3 * 32 * 528 + 512 * 80
    assert K.plan_w8a8_qrows(36864, 512, 512)[1] == 178432
    assert 2 * smem > K.MAX_SMEM


def test_packed_qrows_plan_keeps_bm_64_at_every_k():
    """The packed ring leaves tile 0 room for every even K <= 2048 at N <=
    512, where int8 W drops to BM = 32 above K = 1344."""
    for k in range(2, K.MAX_KN + 1, 2):
        assert K.plan_w8a8_qrows(64, k, 512, packed=True)[0] == 0
    assert K.plan_w8a8_qrows(64, 2048, 512)[0] == 1


@pytest.mark.parametrize("k", [1, 301, 2047])
def test_packed_qrows_plan_refuses_odd_k(k):
    with pytest.raises(ValueError):
        K.plan_w8a8_qrows(4, k, 96, packed=True)
    K.plan_w8a8_qrows(4, k, 96)   # int8 weights take any K


# K4/K8's configuration planner (csrc/quant_gemm.cu): plan_quant_gemm


def _units_of_ctas(units, ctas):
    """The kernel's split of the units among its CTAs: CTA i walks units
    [units * i // ctas, units * (i + 1) // ctas)."""
    return [range(units * i // ctas, units * (i + 1) // ctas) for i in range(ctas)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [2, 64, 130, 300, 512, 896, 1000, 2048, 2050, 4096])
@pytest.mark.parametrize("n", [8, 96, 128, 200, 1000, 1500, 2048])
def test_qgemm_plan_covers_every_output_once(packed, k, n):
    """The map from (CTA, unit, warp, mma fragment) to output elements
    covers every row of M and every column of N exactly once, at M = 1, a
    ragged M and the encoder's 36,864 rows, on the H100's 132 SMs and on a
    card with fewer: the CTAs split the units (BM rows x 128 columns, row
    block major) into contiguous runs, and inside a unit the warps split BM
    into 16-row mma tiles and the 128 columns into n8 tiles, a lane holding
    rows g and g + 8 and columns 2t and 2t + 1 of each 16x8 tile."""
    bn = K.QGEMM_BN
    for m in (1, 129, 36864):
        for sms in (132, 7):
            tile, smem, ctas = K.plan_quant_gemm(m, k, n, packed, sms=sms)
            bm, _ = K.QGEMM_TILES[tile]
            nt = -(-n // bn)
            units = -(-m // bm) * nt
            assert units == K.quant_gemm_units(m, n, tile)
            per_sm = min(K.QGEMM_BLOCKS_PER_SM, K.SM_SMEM // (smem + 1024))
            assert 1 <= ctas == min(units, sms * per_sm)
            runs = _units_of_ctas(units, ctas)
            assert sorted(u for r in runs for u in r) == list(range(units))
            row_cover = np.zeros(-(-m // bm) * bm, np.int32)
            col_cover = np.zeros(nt * bn, np.int32)
            for u in range(units):
                if u % nt == 0:
                    row_cover[(u // nt) * bm:(u // nt + 1) * bm] += 1
                if u < nt:
                    col_cover[u * bn:(u + 1) * bn] += 1
            assert (row_cover == 1).all() and (col_cover == 1).all()
    # inside a unit of each configuration: 8 warps, 2 along BM and 4 along
    # the 128 columns; a lane holds rows g and g + 8 of each 16-row tile and
    # columns 4q .. 4q + 3 of each of the warp's two 16-column groups
    warps_m, warps_n = 2, 4
    for bm, _ in K.QGEMM_TILES:
        wm, wn = bm // warps_m, bn // warps_n
        rows = (np.arange(warps_m)[:, None, None, None] * wm
                + np.arange(wm // 16)[:, None, None] * 16
                + np.arange(8)[:, None] + np.arange(2) * 8).ravel()
        cols = (np.arange(warps_n)[:, None, None, None] * wn
                + np.arange(wn // 16)[:, None, None] * 16
                + np.arange(4)[:, None] * 4 + np.arange(4)).ravel()
        assert np.array_equal(np.sort(rows), np.arange(bm))
        assert np.array_equal(np.sort(cols), np.arange(bn))


@pytest.mark.parametrize("packed", [False, True])
def test_qgemm_plan_shared_memory_and_streamed_limit(packed):
    """At every K it accepts (K8: even K up to 4096) the plan's shared
    memory fits the H100's 232,448 bytes per block, is the configuration's
    own, a multiple of 16 bytes, and holds the int8 x tile and the ring of
    raw W tiles; x stays resident up to K = 2048 and is streamed by K tile
    exactly above it; BM 128 holds K up to 1600 (int8 W) or 1664 (packed)."""
    top = K.MAX_K_W4A8 if packed else 20000
    raw = (32 if packed else 64) * K.QGEMM_BN
    for k in range(2 if packed else 1, top + 1, 2 if packed else 1):
        for m, n in ((36864, 2048), (512, 512)):
            tile, smem, _ = K.plan_quant_gemm(m, k, n, packed)
            bm, resident = K.QGEMM_TILES[tile]
            assert smem == K.quant_gemm_smem(tile, k, packed) <= K.MAX_SMEM
            assert smem % 16 == 0
            assert resident == (k <= K.MAX_RESIDENT_K)
            assert smem >= bm * (k if resident else 64) + K.QGEMM_STAGES * raw
    top0 = 1664 if packed else 1600
    assert max(k for k in range(2, 2049, 2)
               if K.quant_gemm_smem(0, k, packed) <= K.MAX_SMEM) == top0
    # the planner takes BM 128 at the encoder shape, BM 64 at K = 2048 and
    # BM 32 at the decode step's 512 rows
    assert K.plan_quant_gemm(36864, 512, 2048, packed)[0] == 0
    assert K.plan_quant_gemm(36864, 2048, 512, packed)[0] == 1
    assert K.plan_quant_gemm(512, 512, 512, packed)[0] == 2
    with pytest.raises(ValueError):
        K.plan_quant_gemm(64, 2050, 96, packed, tile=1)   # not resident above 2048
    with pytest.raises(ValueError):
        K.plan_quant_gemm(64, top0 + 64, 96, packed, tile=0)  # beyond BM 128's memory


def test_qgemm_plan_main_shape():
    """At [36864,512] x [512,2048]: BM 128, two CTAs per SM (92,672 bytes of
    shared memory, 80,384 with packed W), 264 CTAs walking 4,608 units; at
    [36864,2048] x [2048,512] one CTA per SM holds BM 64's 132 KB x tile."""
    assert K.plan_quant_gemm(36864, 512, 2048) == (0, 92672, 264)
    assert K.plan_quant_gemm(36864, 512, 2048, packed=True) == (0, 80384, 264)
    assert K.quant_gemm_units(36864, 2048, 0) == 288 * 16
    assert K.plan_quant_gemm(36864, 2048, 512) == (1, 156928, 132)
    assert K.plan_quant_gemm(512, 512, 512) == (2, 41600, 64)


@pytest.mark.parametrize("k", [1, 301, 2049])
def test_qgemm_plan_refuses_odd_k_for_packed(k):
    with pytest.raises(ValueError):
        K.plan_quant_gemm(4, k, 96, packed=True)
    K.plan_quant_gemm(4, k, 96)   # int8 weights take any K


@pytest.mark.parametrize("m,k,n,seed,block_k", [
    (37, 130, 200, 31, 2048),    # ragged M, K % 64 != 0, ragged N (N % 16 == 8)
    (129, 304, 136, 32, 2048),   # ragged M past one BM 128 block
    (9, 2050, 96, 33, 2048),     # K just past the resident limit (streamed x)
    (8, 8200, 40, 34, 2048),     # the K-tiled contract with a ragged last K tile
])
def test_k4_ref_matches_jax_interpret_at_kernel_corners(m, k, n, seed, block_k):
    """K4's plain version against the JAX kernel in interpret mode at the
    corners of the new kernel's tiling, as at the JAX tests' shapes:
    rtol 1e-6 / atol 1e-4 (the interpreted kernel contracts an FMA on the
    CPU), and bit-equal to the eager JAX chain."""
    x, wq, sw, b = _case(m, k, n, seed)
    want = np.asarray(JK.quant_w8a8_matmul(*map(jnp.asarray, (x, wq, sw, b)), block_k=block_k,
                                           interpret=True))
    got = K.quant_w8a8_matmul_ref(*_t(x, wq, sw, b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), _eager_chain(x, wq, sw, b))
    assert torch.equal(K.quant_w8a8_matmul(*_t(x, wq, sw, b)), got)


@pytest.mark.parametrize("m,k,n,seed", [
    (37, 130, 200, 41),     # ragged M, K % 64 != 0 and K % 4 == 2, ragged N
    (129, 304, 136, 42),
    (9, 2050, 96, 43),      # past the resident limit, K % 4 == 2
    (5, 4096, 64, 44),      # K8's largest K
])
def test_k8_ref_matches_jax_interpret_at_kernel_corners(m, k, n, seed):
    x, wq, sw, b = _case(m, k, n, seed, int4=True)
    packed = np.asarray(JQ.pack_int4(jnp.asarray(wq)))
    want = np.asarray(JK.quant_w4a8_matmul(*map(jnp.asarray, (x, packed, sw, b)),
                                           interpret=True))
    got = K.quant_w4a8_matmul_ref(*_t(x, packed, sw, b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), _eager_chain(x, wq, sw, b))
    assert torch.equal(K.quant_w4a8_matmul(*_t(x, packed, sw, b)), got)
