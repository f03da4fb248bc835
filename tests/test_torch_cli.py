"""The port's export and serve command lines on the CPU, at a 2-layer
configuration (d_model 32, 4 heads) over small vocabularies, patched into
each CLI module in place of the IWSLT14-base configuration and vocabulary.

- ``python -m onnx_transformer_tpu_torch.export``: from a port checkpoint,
  W8A8 int8 with the int8 cache, one bucket, with the ONNX graphs: the
  bundle loads, its greedy program gives the eager decode's tokens, the
  ONNX graphs parse;
- ``python -m onnx_transformer_tpu_torch.serving``: lines from a file give
  the port engine's translations in input order, for fp32 from a checkpoint
  and for "pallas" with the int8 cache and ``fused_attn`` from seeded params
  (a missing checkpoint warns); ``--raw`` keeps the BPE tokens; ``--tp 2``
  on the CPU (two gloo ranks, one process each) prints the lines of
  ``--tp 0`` (for ``--mode int8`` and ``--mode int4``), and on cards fewer
  cards than ranks is refused.
"""

import numpy as np
import pytest
import torch

from onnx_transformer_tpu_torch.data.dataset import encode_sentence, unbpe
from onnx_transformer_tpu_torch.data.vocab import Vocab
from onnx_transformer_tpu_torch.export import __main__ as export_cli
from onnx_transformer_tpu_torch.export import onnx_proto as OP
from onnx_transformer_tpu_torch.export import serialize as S
from onnx_transformer_tpu_torch.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu_torch.ops import layers as TL
from onnx_transformer_tpu_torch.quant import w8a8 as TW
from onnx_transformer_tpu_torch.serving import __main__ as serve_cli
from onnx_transformer_tpu_torch.serving import decode as TD
from onnx_transformer_tpu_torch.serving.engine import TranslationEngine
from onnx_transformer_tpu_torch.train import checkpoint as CK

SPECIALS = ["<s>", "</s>", "<blank>", "<unk>"]
VS = Vocab(SPECIALS + [f"de{i}" for i in range(37)] + ["ge@@", "hen"])
VT = Vocab(SPECIALS + [f"en{i}" for i in range(27)] + ["wa@@", "lk"])
LINES = ["de1 de2 ge@@ hen de3", "de5", "de7 de8 de9 de10 de11 de12 de13", "",
         "de20 unbekannt de21"]


def small_config(vs, vt):
    return TransformerConfig(len(vs), len(vt), num_layers=2, d_model=32, d_ff=64, num_heads=4)


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    for cli in (export_cli, serve_cli):
        monkeypatch.setattr(cli, "load_iwslt14_vocab", lambda: (VS, VT))
        monkeypatch.setattr(cli, "model_config", small_config)
    model = Transformer(small_config(VS, VT))
    params = model.init(seed=5, device="cpu")
    ckpt = str(tmp_path / "model.npz")
    CK.save(ckpt, {"params": params, "step": torch.tensor(3)})
    rng = np.random.default_rng(2)
    scales = {name: rng.uniform(0.5, 2.0, p["w"].shape[0]).astype(np.float32)
              for name, p in ((n, TW._param_leaf(params, n))
                              for n in TW.quantized_linear_names(2))}
    scales_path = str(tmp_path / "scales.npz")
    np.savez(scales_path, **scales)
    src_path = str(tmp_path / "src.bpe")
    with open(src_path, "w") as f:
        f.write("\n".join(LINES) + "\n")
    return model, params, ckpt, scales, scales_path, src_path


def test_export_cli_writes_a_bundle_that_loads(small_cli, tmp_path, capsys):
    model, params, ckpt, scales, scales_path, _ = small_cli
    out = str(tmp_path / "bundle")
    assert export_cli.main(["--ckpt", ckpt, "--scales", scales_path, "--mode", "int8",
                            "--batch-sizes", "2", "--src-len", "8", "--max-len", "6",
                            "--out", out, "--cpu", "--onnx", "--onnx-qcdq"]) == 0
    printed = capsys.readouterr().out
    assert "greedy_b2.pt2: exported in" in printed and f"-> {out}" in printed
    man = S.load_manifest(out)
    assert man["mode"] == "int8" and man["kv_cache_dtype"] == "int8"
    assert man["config"]["num_layers"] == 2 and man["batch_buckets"] == [2]
    sp, lin = TW.quantize_transformer(model, params, scales, mode="int8")
    src = torch.from_numpy(np.stack([encode_sentence(line, VS, 8) for line in LINES[:2]]))
    sm = TL.make_src_mask(src)
    got = S.load_exported(out, man["graphs"]["greedy"][0]).call(sp, src, sm)
    want = TD.greedy_decode(model, sp, src, sm, 6, lin=lin, kv_cache_dtype="int8")
    assert torch.equal(got, want)
    for graph in ("encoder", "decoder"):
        with open(f"{out}/{graph}.onnx", "rb") as f:
            g = OP.parse_model(f.read())
        assert sum(n.op_type == "QuantizeLinear" for n in g.nodes) == (6 if graph == "encoder"
                                                                       else 10) * 2


def _engine_lines(model, params, lin, kv, fused, raw=False):
    eng = TranslationEngine(model, params, lin=lin, num_slots=4, src_len=10, max_len=8,
                            kv_cache_dtype=kv, fused_attn=fused)
    order = {eng.submit(encode_sentence(line, VS, 10)): n for n, line in enumerate(LINES)}
    out = [""] * len(LINES)
    for req in eng.run():
        toks = [VT.itos[t] for t in req.out_tokens]
        out[order[req.req_id]] = " ".join(toks) if raw else unbpe(toks)
    return out


@pytest.mark.parametrize("mode,kv,fused,raw", [("fp32", "fp32", False, False),
                                               ("pallas", "int8", True, True)])
def test_serve_cli_translates_as_the_engine(small_cli, tmp_path, capsys, mode, kv, fused, raw):
    model, params, ckpt, scales, scales_path, src_path = small_cli
    argv = ["--mode", mode, "--kv-dtype", kv, "--input", src_path, "--num-slots", "4",
            "--src-len", "10", "--max-len", "8", "--platform", "cpu", "--scales", scales_path]
    if mode == "fp32":
        argv += ["--ckpt", ckpt]
        want = _engine_lines(model, params, TW.default_linear, kv, fused, raw)
    else:
        # no checkpoint: params from seed 0
        argv += ["--ckpt", str(tmp_path / "absent.npz")]
        seeded = model.init(seed=0, device="cpu")
        sp, lin = TW.quantize_transformer(model, seeded, scales, mode=mode)
        want = _engine_lines(model, sp, lin, kv, fused, raw)
    argv += ["--fused-attn"] if fused else []
    argv += ["--raw"] if raw else []
    assert serve_cli.main(argv) == 0
    captured = capsys.readouterr()
    assert captured.out.splitlines() == want
    assert f"# {len(LINES)} sentences" in captured.err
    assert ("missing, random params" in captured.err) == (mode != "fp32")


def test_serve_cli_tensor_parallel_prints_the_lines_of_one_device(small_cli, capsys):
    _, _, ckpt, _, scales_path, src_path = small_cli
    argv = ["--mode", "int8", "--kv-dtype", "int8", "--input", src_path, "--num-slots", "4",
            "--src-len", "10", "--max-len", "8", "--platform", "cpu", "--scales",
            scales_path, "--ckpt", ckpt]
    assert serve_cli.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert serve_cli.main(argv + ["--tp", "2"]) == 0
    captured = capsys.readouterr()
    assert captured.out.splitlines() == want and len(want) == len(LINES)
    assert f"# {len(LINES)} sentences" in captured.err and "tp=2" in captured.err


def test_serve_cli_int4_tensor_parallel_prints_the_lines_of_one_device(small_cli, capsys):
    _, _, ckpt, _, _, src_path = small_cli
    argv = ["--mode", "int4", "--kv-dtype", "int8", "--input", src_path, "--num-slots", "4",
            "--src-len", "10", "--max-len", "8", "--platform", "cpu", "--ckpt", ckpt]
    assert serve_cli.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert serve_cli.main(argv + ["--tp", "2"]) == 0
    captured = capsys.readouterr()
    assert captured.out.splitlines() == want and len(want) == len(LINES)
    assert "mode=int4" in captured.err and "tp=2" in captured.err


def test_serve_cli_nccl_needs_a_card_per_rank(small_cli, capsys):
    *_, src_path = small_cli
    with pytest.raises(SystemExit):
        serve_cli.main(["--tp", str(torch.cuda.device_count() + 1), "--input", src_path,
                        "--platform", "cuda"])
    assert "needs a card per rank" in capsys.readouterr().err
