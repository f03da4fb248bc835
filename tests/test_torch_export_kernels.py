"""Kernel bundles of the port's export (export/serialize.py), against the
port's eager decode and the JAX package's live decode.

On the small configuration of tests/test_export.py's int8 bundle
(vocabularies 41/37, 2 layers, d_model 32, 4 heads), bucket 4 x 9, W8A8
"pallas" with ``fused_attn`` and the int8 cache, and W8A8 "fused" with
``FUSED_MIN_TOKENS`` lowered in both packages so that the 36 source tokens
take K1/K2: each exported graph holds the expected count of each ``otk``
operator node (the kernels as registered operators), and the loaded
greedy program and prefill + decode-step loop give the port's eager tokens
and JAX's live decode's (its Pallas kernels interpreted on the CPU).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.ops import layers as JL
from onnx_transformer_tpu.quant import w8a8 as JW
from onnx_transformer_tpu.serving import decode as JD
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.export import serialize as TS
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving import decode as TD
from test_torch_export import _loop, _models

MAX_LEN = 5


def _otk_nodes(program) -> dict:
    """Calls of each ``otk`` operator in a program's graph and its
    subgraphs (the greedy decode's ``no_grad`` region is one)."""
    return dict(collections.Counter(
        str(n.target).split(".")[1]
        for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
        for n in gm.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("otk.")))


def _kernel_bundle(tmp_path_factory, mode, fused_attn, min_tokens):
    """Both packages' live decode and the port's bundle (all four programs)
    under a W8A8 mode that reaches the kernels, at bucket 4 x 9, max_len 5."""
    m, params, pm, pp = _models(41, 37, 5)
    old = (JW.FUSED_MIN_TOKENS, TW.FUSED_MIN_TOKENS)
    JW.FUSED_MIN_TOKENS = TW.FUSED_MIN_TOKENS = min_tokens
    try:
        sp, jlin = JW.quantize_transformer(m, params, mode=mode)
        psp, plin = TW.quantize_transformer(pm, params_from_jax(params, device="cpu"),
                                            mode=mode)
        src = np.random.default_rng(9).integers(4, 41, (4, 9)).astype(np.int32)
        src[2, -3:] = 2
        sm = np.array(JL.make_src_mask(jnp.asarray(src)))
        tsrc, tsm = torch.from_numpy(src), torch.from_numpy(sm)
        kw = dict(kv_cache_dtype="int8", fused_attn=fused_attn)
        live = {eos: np.asarray(JD.greedy_decode(m, sp, jnp.asarray(src), jnp.asarray(sm),
                                                 MAX_LEN, lin=jlin, stop_at_eos=eos, **kw))
                for eos in (True, False)}
        eager = {eos: TD.greedy_decode(pm, psp, tsrc, tsm, MAX_LEN, lin=plin, stop_at_eos=eos,
                                       **kw).numpy() for eos in (True, False)}
        out = str(tmp_path_factory.mktemp(f"torch_{mode}"))
        TS.export_model(pm, psp, out, batch_sizes=(4,), src_len=9, max_len=MAX_LEN, lin=plin,
                        mode=mode, **kw)
    finally:
        JW.FUSED_MIN_TOKENS, TW.FUSED_MIN_TOKENS = old
    programs = {g: TS.load_exported(out, f"{g}_b4.pt2")
                for g in ("encoder", "prefill", "decode_step", "greedy")}
    return psp, programs, src, sm, live, eager


@pytest.fixture(scope="module")
def pallas_bundle(tmp_path_factory):
    return _kernel_bundle(tmp_path_factory, "pallas", True, 8192)


@pytest.fixture(scope="module")
def fused_bundle(tmp_path_factory):
    # 36 source tokens take K1/K2 in the encoder and the cross-K/V; the
    # 4-token decode steps stay on the int8 chain
    return _kernel_bundle(tmp_path_factory, "fused", False, 32)


# otk operator nodes per program at 2 layers and MAX_LEN (MAX_LEN - 1 steps):
# K5 for each of the encoder's 6 linears a layer, the 2 cross-K/V
# projections and the 8 linears of a decoder step; K3 for the 2 attentions
# of a decoder layer's step
STEPS = MAX_LEN - 1
KERNEL_NODES = {
    "pallas": {"encoder": {"w8a8_matmul": 12},
               "prefill": {"w8a8_matmul": 16},
               "decode_step": {"w8a8_matmul": 16, "decode_attention_int8": 4},
               "greedy": {"w8a8_matmul": 16 + STEPS * 16,
                          "decode_attention_int8": STEPS * 4}},
    "fused": {"encoder": {"quant_w8a8_matmul_qout": 6},
              "prefill": {"quant_w8a8_matmul_qout": 6, "quant_w8a8_matmul_q8": 4},
              "decode_step": {},
              "greedy": {"quant_w8a8_matmul_qout": 6, "quant_w8a8_matmul_q8": 4}},
}


@pytest.mark.parametrize("mode", ["pallas", "fused"])
def test_kernel_bundle_graphs_hold_the_operators(mode, pallas_bundle, fused_bundle):
    _, programs, *_ = pallas_bundle if mode == "pallas" else fused_bundle
    for graph, want in KERNEL_NODES[mode].items():
        assert _otk_nodes(programs[graph].program) == want, graph


@pytest.mark.parametrize("mode", ["pallas", "fused"])
def test_kernel_bundle_tokens_match_eager_and_jax(mode, pallas_bundle, fused_bundle):
    psp, programs, src, sm, live, eager = pallas_bundle if mode == "pallas" else fused_bundle
    tsrc, tsm = torch.from_numpy(src), torch.from_numpy(sm)
    greedy = programs["greedy"].call(psp, tsrc, tsm).numpy()
    np.testing.assert_array_equal(greedy, eager[True])
    np.testing.assert_array_equal(greedy, live[True])
    pre, step = programs["prefill"], programs["decode_step"]

    def call_step(cache, last, pos, sm):
        logp, cache = step.call(psp, cache, torch.from_numpy(np.ascontiguousarray(last)),
                                torch.from_numpy(pos), torch.from_numpy(sm))
        return logp.numpy(), cache

    loop = _loop(lambda s, m: pre.call(psp, torch.from_numpy(s), torch.from_numpy(m)),
                 call_step, src, sm, MAX_LEN)
    np.testing.assert_array_equal(loop, eager[False])
    np.testing.assert_array_equal(loop, live[False])
