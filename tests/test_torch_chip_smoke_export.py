"""chip_smoke.py's "export" phase rehearsed on the CPU at a small size: a
2-layer model of the card's widths, the kernels' operator calls counted
as their CUDA implementations count them on the card (an exported
program calls the operators, not the wrappers), the serve command line at
2 layers.  The loaded programs launch what eager launches, and a wrong
token in the loaded loop fails the phase."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as C
from onnx_transformer_tpu_torch.ops.kernels import decode_attention as KA
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM
from onnx_transformer_tpu_torch.quant import w8a8 as TW

CPU = torch.device("cpu")


class _CountOps(TorchDispatchMode):
    """Counts each call of a kernel's operator (``torch.ops.otk.*``) on its
    wrapper, as the operator's CUDA implementation does on the card: an
    exported program calls the operators, not the wrappers."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "otk":
            name = func._schema.name.split("::")[1]
            (KA if name == "decode_attention_int8" else KM).__dict__[name].launches += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def export_rehearsal(monkeypatch):
    """The export phase on the CPU: a 2-layer model of the card's widths,
    the kernels' operators counted, the serve command line at 2 layers."""
    from onnx_transformer_tpu_torch.models.transformer import TransformerConfig
    from onnx_transformer_tpu_torch.serving import __main__ as serve_cli

    real = C.counted_run

    def counting_run(fn, sync):
        def counted():
            with _CountOps():
                return fn()
        return real(counted, sync)

    monkeypatch.setattr(C, "counted_run", counting_run)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(serve_cli, "model_config",
                        lambda vs, vt: TransformerConfig(len(vs), len(vt), num_layers=2))
    # the "fused" bundle's 6 x 9 sources take K1/K2
    monkeypatch.setattr(TW, "FUSED_MIN_TOKENS", 50)
    return C.build_iwslt(CPU, num_layers=2, batch=6, src_len=9)


EXPORT_TINY = dict(bucket=3, fused_bucket=6, max_len=6, greedy_cut=3, lines=5)


def test_export_phase_launch_counts(export_rehearsal):
    """The loaded programs launch what eager launches: K5 8 a layer in the
    prefill and 8 a layer a step, K3 2 a layer a step; the fused prefill K1
    3 and K2 2 a layer; the serve command line K3 and K5."""
    res = C.run_export_path(CPU, export_rehearsal, export_rehearsal, card="cpu", **EXPORT_TINY)
    n, steps = 2, EXPORT_TINY["max_len"] - 1
    assert res["pallas"]["launches"] == {"w8a8": 8 * n + 8 * n * steps, "attn": 2 * n * steps}
    assert res["fused"] == {"encoder": {"qout": 3 * n}, "prefill": {"qout": 3 * n, "q8": 2 * n}}
    assert res["serve"]["launches"]["attn"] and res["serve"]["launches"]["w8a8"]
    assert set(res["onnx_bytes"]) == {f"{v} {g}.onnx" for v in ("weight-QDQ", "QCDQ")
                                      for g in ("encoder", "decoder")}


def test_export_gate_catches_a_wrong_token(export_rehearsal, monkeypatch):
    """A loaded decode step whose argmax moves at one row and step fails
    the phase."""
    from onnx_transformer_tpu_torch.export import serialize as S

    real = S.LoadedProgram.call
    steps = []

    def wrong(self, *args):
        out = real(self, *args)
        if self.name.startswith("decode_step"):
            steps.append(1)
            if len(steps) == 3:
                logp = out[0].clone()
                logp[1, (logp[1].argmax() + 1) % logp.shape[1]] = 1e9
                return logp, out[1]
        return out

    monkeypatch.setattr(S.LoadedProgram, "call", wrong)
    with pytest.raises(AssertionError, match="loaded pallas programs' tokens differ"):
        C.run_export_path(CPU, export_rehearsal, export_rehearsal, card="cpu", **EXPORT_TINY)
