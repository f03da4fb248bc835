"""chip_smoke.py's phases rehearsed on the CPU at a tiny size: the kernel
checks, the chunk-staged main path, the KV-cached serving path with its
launch counts, the int4 path with its launch counts, the reference phase,
the shape lists, bounds and SASS counts, and the train phase.  The fault
campaign's rehearsal is in ``test_torch_chip_smoke_campaign.py``, the
engine's in ``test_torch_chip_smoke_engine.py``, the command lines' in
``test_torch_chip_smoke_cli.py``.  On the CPU the kernel wrappers take
their plain versions and count nothing, so each wrapper is wrapped to count
its calls (``tests/chip_smoke_rehearsal.py``); the CUDA-only timing and
profiling are stubbed.  The script itself runs on the card (``python3
chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import chip_smoke as C
from chip_smoke_rehearsal import CPU, rehearsal  # noqa: F401  (a fixture)
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM
from onnx_transformer_tpu_torch.quant import w8a8 as TW


def test_kernel_checks(rehearsal):
    # K1/K2 at the card check's shapes, all but the main path's 36,864 rows
    # and the engine prefills' 12,288 to 24,576
    k12 = [s for s in C.K12_SHAPES if np.prod(s[0]) <= 1000]
    assert len(k12) == len(C.K12_SHAPES) - 4
    rows = C.check_kernels(CPU, [((4, 7), 64, 96)] + k12, ((4, 7), 64, 96))
    k5_times = [((16,), 64, 64), ((16,), 64, 256), ((16,), 256, 64), ((40,), 64, 64)]
    rows.update(C.check_k5(CPU, [((5,), 64, 96), ((1,), 300, 96), ((4, 15), 128, 128)],
                           k5_times))
    # K5's row carries a time at every shape it was timed at, the first (the
    # decode step's) in its top-level keys
    shapes = rows["w8a8"]["shapes"]
    assert [s["shape"] for s in shapes] == [[m, k, n] for (m,), k, n in k5_times]
    for s in shapes:
        assert {"ms", "plain_ms", "bound_ms", "bound_by", "int_mm_ms", "tile"} <= set(s)
        assert s["bound_ms"] > 0
    assert rows["w8a8"]["bound_ms"] == shapes[0]["bound_ms"]
    rows.update(C.check_k3(CPU, [(6, 9, 64, 4), (3, 1, 64, 4), (2, 9, 18, 3),
                                 (6, 9, 64, 4, "ring")], (6, 9, 64, 4)))
    # K6/K7 at theirs, all but the four with thousands of rows
    k67 = [s for s in C.K67_SHAPES if np.prod(s[0]) <= 1000]
    assert len(k67) == len(C.K67_SHAPES) - 4
    rows.update(C.check_kernels(CPU, [((4, 7), 64, 96)] + k67, ((4, 7), 64, 96), packed=True))
    # K4/K8 at theirs, all but the four with thousands of rows (the plain
    # version's product is slow on the CPU) and K8's five of phase
    # "parallel" with 1,024 columns or 2,304 rows, timed at small stand-ins
    # for the three time shapes
    small = {key: [s for s in shapes if np.prod(s[0]) <= 1000 and s[2] <= 1000]
             for key, shapes in C.QGEMM_SHAPES.items()}
    assert [len(C.QGEMM_SHAPES[key]) - len(small[key]) for key in small] == [4, 4 + 5]
    q_times = [((16,), 64, 256), ((16,), 256, 64), ((8,), 64, 64)]
    rows.update(C.check_quant_gemm(CPU, small, q_times))
    for key in ("qgemm", "qgemm4"):
        shapes = rows[key]["shapes"]
        assert [s["shape"] for s in shapes] == [[m, k, n] for (m,), k, n in q_times]
        for s in shapes:
            assert {"ms", "plain_ms", "bound_ms", "int_mm_ms", "k5_chain_ms", "tiles_ms"} <= set(s)
        assert rows[key]["bound_ms"] == shapes[0]["bound_ms"]
    assert sorted(rows) == sorted(k for k in C.KERNELS)
    keys = {"ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "partial_yardstick"}
    for row in rows.values():
        assert keys <= set(row) and row["bound_ms"] > 0


def test_paths_and_launch_counts(rehearsal):
    base = C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)
    main = C.run_main_path(CPU, base, max_len=8, chunk=4, card="cpu")
    assert main["agree"] == 1.0
    serve = C.run_serving_path(CPU, base, max_len=8, card="cpu")
    # K3: 2 per layer per step; K5: 6 per encoder layer, 2 cross-K/V and 8
    # per layer per step; K1/K2 never
    assert serve["launches"] == {"attn": 2 * 2 * 7, "w8a8": 12 + 4 + 8 * 2 * 7,
                                 "qout": 0, "q8": 0}
    assert serve["agree"] == serve["agree_chunked"] == serve["agree_plain_attn"] == 1.0
    assert C.run_reference(CPU) == 1.0


def test_int4_path_launch_counts(rehearsal, monkeypatch):
    """With the token threshold at 1, the tiny encoder's q/k/v take K6 and
    its cross-K/V K7, as the full-size encoder does on the card."""
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 1)
    base = C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)
    res = C.run_int4_path(CPU, base, max_len=8, chunk=4, card="cpu")
    assert res["launches"]["qout4"] == 3 * 2 and res["launches"]["q84"] == 2 * 2
    assert sum(res["launches"].values()) == 10
    assert res["agree"] == 1.0


def test_bound_counts_packed_weights():
    """Packed int4 weights count half the bytes of int8 ones."""
    m, k, n = 36864, 512, 2048
    full, _ = C.bound_ms(m, k, n, 4 * n)
    packed, by = C.bound_ms(m, k, n, 4 * n, k * n // 2)
    assert by == "bytes"
    assert np.isclose((full - packed) * 1e-3 * C.HBM_BYTES_PER_S, k * n / 2)


def test_bounds():
    """Bytes over 3.35 TB/s against operations over their peak rate."""
    ms, by = C.roofline_ms(3.35e9, 1.0, C.INT8_OPS_PER_S)
    assert by == "bytes" and np.isclose(ms, 1.0)
    ms, by = C.roofline_ms(1.0, 1979e9, C.INT8_OPS_PER_S)
    assert by == "operations" and np.isclose(ms, 1.0)


def test_k12_shapes_reach_every_kernel_instance():
    """The card check's K1/K2 shapes run every configuration of
    plan_w8a8_qrows, each with 16-byte loads (K % 4 == 0, N % 16 == 0) and
    with scalar ones, and include the shapes the port's main path and its
    edges need."""
    reached = set()
    for lead, k, n in C.K12_SHAPES:
        tile = KM.plan_w8a8_qrows(int(np.prod(lead)), k, n)[0]
        reached.add((tile, k % 4 == 0 and n % 16 == 0))
    assert reached == {(t, v) for t in range(len(KM.QROWS_TILES)) for v in (True, False)}
    for shape in [((512, 72), 512, 512), ((64,), 2048, 512), ((64,), 512, 2048),
                  ((32,), 2048, 2048), ((1,), 300, 96), ((4, 15), 128, 128), ((129,), 304, 200)]:
        assert shape in C.K12_SHAPES
    # the serving engine's staged prefills: slots x bucket rows of E1/E2
    # (512 x 24/48/72) and E3 (256 x 24/48/72), at the encoder's q/k/v and
    # the cross-K/V widths
    rows = {int(np.prod(lead)) for lead, k, n in C.K12_SHAPES if (k, n) == (512, 512)}
    assert {k * sb for k in (512, 256) for sb in (48, 72)} <= rows and 512 * 24 in rows
    # K6/K7's (even K only): every configuration their planner can give (it
    # never gives tile 1 for packed weights, which w4a8_qrows.cu does not
    # build) with both loads, and a K % 4 == 2
    reached = set()
    for lead, k, n in C.K67_SHAPES:
        assert k % 2 == 0
        tile = KM.plan_w8a8_qrows(int(np.prod(lead)), k, n, packed=True)[0]
        reached.add((tile, k % 4 == 0 and n % 16 == 0))
    assert reached == {(t, v) for t in (0, 2, 3) for v in (True, False)}
    assert set(C.K12_SHAPES) < set(C.K67_SHAPES)
    assert any(k % 4 == 2 for _, k, _ in C.K67_SHAPES)


def test_k5_and_k3_checks_cover_the_engine():
    """K5 is checked at the engine prefills' rows (512 slots x each bucket)
    for every product of the encoder and the cross-K/V, at every shape that
    phase "parallel" gives it, one device's and a rank's, and K3 at the
    general chunk's wrapped age masks: per row a window of the last lpos + 1
    positions ending at the ring index, empty for a dead slot, wrapping past
    T - 1."""
    for m in (512 * 24, 512 * 48, 512 * 72):
        for k, n in ((512, 512), (512, 2048), (2048, 512)):
            assert ((m,), k, n) in C.K5_SHAPES
    # phase "parallel": one device's products and a rank's column-parallel
    # ones at model=2, at the logit check's and the engine's rows
    d, ff, tp = 512, 2048, 2
    slots, seq = C.TP_ENGINE["slots"], C.TP_ENGINE["seq"]
    rows = ({slots} | {slots * b for b in C.TP_ENGINE["buckets"]}
            | set(C.TP_LOGIT_ROWS) | {r * seq for r in C.TP_LOGIT_ROWS})
    for m in rows:
        for k, n in ((d, d), (d, ff), (ff, d), (d, d // tp), (d, ff // tp)):
            assert ((m,), k, n) in C.K5_SHAPES
    assert (512, 72, 512, 8, "ring") in C.K3_CASES
    b, t = 64, 9
    *_, mask = C.k3_inputs(b, t, 8, seed=3, device=CPU, ring=True)
    wrapped = 0
    for row in mask.tolist():
        vis = [p for p in range(t) if row[p]]
        if not vis:
            continue
        # the visible set is one window of consecutive positions mod T
        starts = [p for p in vis if not row[(p - 1) % t]]
        assert len(starts) == 1 or len(vis) == t
        wrapped += row[0] and row[t - 1] and len(vis) < t
    assert not all(mask.any(1)) and wrapped > 0


def test_qgemm_shapes_reach_every_kernel_instance():
    """The card check's K4/K8 shapes run every configuration of
    plan_quant_gemm on the H100's 132 SMs (BM 128, 64 and 32 with x
    resident, BM 64 with x streamed), each with 16-byte loads (K % 4 == 0,
    N % 16 == 0) and with scalar ones, for K4 and for K8; and include the
    three timed shapes and K4's K-tiled gates at K = 16384 and K = 9728."""
    for key, packed in (("qgemm", False), ("qgemm4", True)):
        reached = set()
        for lead, k, n in C.QGEMM_SHAPES[key]:
            assert not packed or (k % 2 == 0 and k <= KM.MAX_K_W4A8)
            tile = KM.plan_quant_gemm(int(np.prod(lead)), k, n, packed, sms=132)[0]
            reached.add((tile, k % 4 == 0 and n % 16 == 0))
        assert reached == {(t, v) for t in range(len(KM.QGEMM_TILES)) for v in (True, False)}
        assert set(C.QGEMM_TIME_SHAPES) <= set(C.QGEMM_SHAPES[key])
    assert {((24,), 16384, 96), ((16,), 9728, 64)} <= set(C.QGEMM_SHAPES["qgemm"])
    assert C.QGEMM_TIME_SHAPES[0] == ((36864,), 512, 2048)


def test_count_sass():
    """The tensor-core and dp4a instructions of one kernel's functions in
    cuobjdump's SASS listing; other functions are not counted."""
    sass = """
        Function : _ZN12_GLOBAL__N_116w8a8_gemm_kernelINS_4TileILi64EEELb1EEEvPKa
        /*0100*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0110*/                   IMMA.16832.S8.S8 R24, R8.ROW, R20.COL, R24 ;
        /*0120*/                   IMMA.16832.S8.S8 R28, R8.ROW, R22.COL, R28 ;
        Function : _ZN12_GLOBAL__N_116dp4a_gemm_kernelILb1EEEvPKfPKhS2_S2_Pfiii
        /*0100*/                   IDP.4A.S8.S8 R4, R5, R6, R4 ;
        Function : _ZN12_GLOBAL__N_117quant_gemm_kernelINS_5QGemmILi128ELi2ELb1ELb0ELi1EEELb1EEEvPKf
        /*0100*/                   IMMA.16832.S8.S8 R24, R8.ROW, R20.COL, R24 ;
        Function : _ZN12_GLOBAL__N_116w8a8_gemm_kernelINS_4TileILi32EEELb0EEEvPKa
        /*0200*/                   IMMA.16832.S8.S8 R24, R8.ROW, R20.COL, R24 ;
        Function : _ZN12_GLOBAL__N_122w8a8_qrows_qout_kernelINS_5QRowsILi64EEELb1EEEvPKf
        /*0100*/                   IMMA.16832.S8.S8 R24, R8.ROW, R20.COL, R24 ;
        Function : _ZN12_GLOBAL__N_120w8a8_qrows_q8_kernelINS_5QRowsILi64EEELb1EEEvPKf
        /*0100*/                   IMMA.16832.S8.S8 R24, R8.ROW, R20.COL, R24 ;
        Function : _ZN12_GLOBAL__N_122w4a8_qrows_qout_kernelINS_5QRowsILi64EEELb1EEEvPKf
        /*0100*/                   LOP3.LUT R4, R5, 0xf0f0f0f, RZ, 0xc0, !PT ;
        /*0110*/                   IMMA.16832.S8.S8 R24, R8.ROW, R20.COL, R24 ;
        /*0120*/                   IMMA.16832.S8.S8 R28, R8.ROW, R22.COL, R28 ;
    """
    assert C.count_sass(sass, "w8a8_gemm_kernel") == {"IMMA": 3, "HGMMA": 0, "IDP": 0}
    assert C.count_sass(sass, "dp4a_gemm_kernel") == {"IMMA": 0, "HGMMA": 0, "IDP": 1}
    assert C.count_sass(sass, "quant_gemm_kernel") == {"IMMA": 1, "HGMMA": 0, "IDP": 0}
    # K1 and K2 are counted together under their shared prefix, K6/K7 apart
    assert C.count_sass(sass, "w8a8_qrows") == {"IMMA": 2, "HGMMA": 0, "IDP": 0}
    assert C.count_sass(sass, "w4a8_qrows") == {"IMMA": 2, "HGMMA": 0, "IDP": 0}


def test_device_ms_of():
    """Device ms and launches summed over the kernels whose name matches,
    as the serving path reports K5 and K3 per decode."""
    prof = {"busy_ms": 9.0, "by_kernel": {
        "void (anonymous namespace)::w8a8_gemm_kernel<Tile<64, 32>, true>(...)": (3.0, 30),
        "void (anonymous namespace)::w8a8_gemm_kernel<Tile<128, 128>, true>(...)": (2.5, 4),
        "void (anonymous namespace)::decode_attn_kernel<true>(...)": (1.5, 12)}}
    assert C.device_ms_of(prof, "w8a8_gemm_kernel") == (5.5, 34)
    assert C.device_ms_of(prof, "decode_attn_kernel") == (1.5, 12)
    # K1 and K2 apart, as the main path reports them
    prof["by_kernel"].update({
        "void (anonymous namespace)::w8a8_qrows_qout_kernel<QRows<64, 512, 1, 2>, true>(...)":
            (0.2, 18),
        "void (anonymous namespace)::w8a8_qrows_q8_kernel<QRows<64, 512, 1, 2>, true>(...)":
            (0.1, 12)})
    assert C.device_ms_of(prof, "w8a8_qrows_qout_kernel") == (0.2, 18)
    assert C.device_ms_of(prof, "w8a8_qrows_q8_kernel") == (0.1, 12)
    # K6 and K7 apart from them, as the int4 path reports them
    prof["by_kernel"].update({
        "void (anonymous namespace)::w4a8_qrows_qout_kernel<QRows<64, 512, 1, 2, true>, true>"
        "(...)": (0.25, 18),
        "void (anonymous namespace)::w4a8_qrows_q8_kernel<QRows<64, 512, 1, 2, true>, true>"
        "(...)": (0.125, 12)})
    assert C.device_ms_of(prof, "w4a8_qrows_qout_kernel") == (0.25, 18)
    assert C.device_ms_of(prof, "w4a8_qrows_q8_kernel") == (0.125, 12)
    assert C.device_ms_of(prof, "w8a8_qrows_qout_kernel") == (0.2, 18)
    assert C.device_ms_of(None, "decode_attn_kernel") == (0, 0)


# ------------------------------------------------------------- train phase

TRAIN_TINY = dict(num_layers=1, n_pairs=1200, budget=512, parity=(4, 16), timed_steps=2,
                  learn_batch=(16, 16))


def test_train_corpus_follows_the_length_mix():
    """The synthetic pairs: source lengths with BOS and EOS in the IWSLT14
    mix (57 % of 4-24, 33 % of 25-48, 10 % of 49-72, each share within
    0.02 at 6,000 pairs), targets within 3 tokens of their source, every
    token in its vocabulary and none a special."""
    from onnx_transformer_tpu_torch.data.vocab import SPECIALS, load_iwslt14_vocab

    vs, vt = load_iwslt14_vocab()
    pairs = C.train_pairs(6000, vs, vt, seed=60)
    lens = np.array([len(s.split()) + 2 for s, _ in pairs])
    assert lens.min() >= 4 and lens.max() <= 72
    shares = [np.mean((lens >= lo) & (lens <= hi)) for lo, hi in ((4, 24), (25, 48), (49, 72))]
    assert np.allclose(shares, [0.57, 0.33, 0.10], atol=0.02), shares
    for s, t in pairs:
        a, b = s.split(), t.split()
        assert abs(len(a) - len(b)) <= 3 and b
        assert all(w in vs and w not in SPECIALS for w in a)
        assert all(w in vt and w not in SPECIALS for w in b)


def test_train_token_budget_batch_sizes():
    """At 12,288 tokens the buckets 16/24/32/48/72 take 768/512/384/256/168
    pairs, and the corpus fills every bucket."""
    from onnx_transformer_tpu_torch.data.dataset import BucketedLoader
    from onnx_transformer_tpu_torch.data.vocab import load_iwslt14_vocab

    vs, vt = load_iwslt14_vocab()
    loader = BucketedLoader(C.train_pairs(8000, vs, vt, seed=60), vs, vt,
                            token_budget=C.TRAIN_BUDGET, max_padding=72, seed=0)
    assert tuple(loader.length_buckets) == C.TRAIN_BUCKETS
    sizes = [loader._bucket_bsz(length) for length in C.TRAIN_BUCKETS]
    assert sizes == [768, 512, 384, 256, 168]
    assert all(b * length <= C.TRAIN_BUDGET for b, length in zip(sizes, C.TRAIN_BUCKETS))
    shapes = [b.src.shape for b in loader]
    assert set(shapes) == set(zip(sizes, C.TRAIN_BUCKETS))
    assert len(shapes) >= len(C.TRAIN_BUCKETS) + 10


def test_train_flops_and_mfu():
    """bench.py's FLOP count at the IWSLT14-base widths (6+6 layers,
    d_model 512, d_ff 2048, target vocabulary 4444) and the MFU against the
    H100's dense bf16 peak, 989.4 TFLOP/s (not a TPU's)."""
    import onnx_transformer_tpu_torch as P

    cfg = P.TransformerConfig(5337, 4444)
    enc = 6 * (4 * 512 * 512 + 2 * 512 * 2048)
    dec = 6 * (8 * 512 * 512 + 2 * 512 * 2048)
    assert C.train_flops_per_token(cfg) == 6 * (enc + dec + 512 * 4444) == 277_893_120
    assert C.BF16_FLOPS_PER_S == 989.4e12
    assert C.train_mfu(1e6, cfg) == pytest.approx(277_893_120e6 / 989.4e12, rel=1e-12)


def test_train_phase_rehearsal(rehearsal):
    """The train phase at full width, 1 layer and a 512-token budget: card
    and CPU parity (both the CPU here), the recipe's warm and timed steps,
    learning, QAT and the checkpoint resume, and no kernel launch."""
    res = C.run_train_path(CPU, card="cpu", **TRAIN_TINY)
    for rounding in ("on", "off"):
        assert res[f"parity_rounding_{rounding}"] == {"loss_rel": 0.0, "grad_share": 0.0}
    assert res["recipe"]["tokens_per_s"] > 0 and res["recipe"]["mfu"] > 0
    assert res["learning"]["last"] < C.LEARN_SHARE * res["learning"]["first"]
    q = res["learning"]["qat"]
    assert len(q) == C.QAT_STEPS and q[-1] < q[0]


def test_train_gates_catch_wrong_values():
    """check_learning refuses a loss that does not fall far enough, or one
    that is not finite; check_resume refuses a state one ulp off."""
    C.check_learning([7.0, 1.0], 0.25, "x")
    for losses in ([7.0, 2.0], [7.0, float("nan")], [float("inf"), 1.0]):
        with pytest.raises(AssertionError, match="train x"):
            C.check_learning(losses, 0.25, "x")
    a = {"params": {"w": torch.ones(3)}, "step": torch.tensor(2, dtype=torch.int32)}
    b = {"params": {"w": torch.nextafter(torch.ones(3), torch.full((3,), 2.0))},
         "step": torch.tensor(2, dtype=torch.int32)}
    C.check_resume(a, a)
    with pytest.raises(AssertionError, match="differs at params/w"):
        C.check_resume(a, b)


@pytest.mark.parametrize("fault", ["learning", "checkpoint"])
def test_train_gate_catches_a_wrong_run(rehearsal, monkeypatch, fault):
    """An optimizer that does not move the weights fails the learning gate;
    a restore that returns one weight an ulp off fails the checkpoint
    gate."""
    from onnx_transformer_tpu_torch.train import checkpoint as CK
    from onnx_transformer_tpu_torch.train import trainer as TT

    if fault == "learning":
        monkeypatch.setattr(TT.AdamNoam, "update_", lambda self, params, grads, state: None)
        match = "train learning"
    else:
        real = CK.restore

        def off_by_an_ulp(path, template):
            tree = real(path, template)
            w = tree["params"]["generator"]["b"]
            w[0] = torch.nextafter(w[0], w[0] + 1)
            return tree

        monkeypatch.setattr(CK, "restore", off_by_an_ulp)
        match = "train checkpoint: the resumed step differs"
    with pytest.raises(AssertionError, match=match):
        C.run_train_path(CPU, card="cpu", **TRAIN_TINY)
