"""Port of utils/torch_compat.py against the JAX package.

- ``to_torch_state_dict`` gives the JAX package's state dict key for key,
  bit for bit, as contiguous CPU tensors in the reference's (out, in) layout;
- ``from_torch_state_dict`` round-trips it into the port's param tree on the
  device asked for;
- ``load_reference_checkpoint`` on a ``torch.save``d synthetic state dict
  equals JAX's conversion of the same file.
"""

import jax
import numpy as np
import pytest
import torch

from onnx_transformer_tpu.models.transformer import Transformer, TransformerConfig
from onnx_transformer_tpu.utils import torch_compat as JT
from onnx_transformer_tpu_torch import params_from_jax
from onnx_transformer_tpu_torch.params import tree_paths
from onnx_transformer_tpu_torch.utils import torch_compat as TT


@pytest.fixture(scope="module")
def small():
    """tests/test_torch_compat.py:14-21."""
    cfg = TransformerConfig(src_vocab_size=19, tgt_vocab_size=17, num_layers=2, d_model=16,
                            d_ff=32, num_heads=2, dropout=0.0)
    params = Transformer(cfg).init(jax.random.key(2))
    return params, params_from_jax(params, device="cpu")


def test_to_torch_state_dict_equals_jax(small):
    params, pp = small
    want = JT.to_torch_state_dict(params)
    got = TT.to_torch_state_dict(pp)
    assert list(got) == list(want)
    for key, arr in want.items():
        t = got[key]
        assert t.device.type == "cpu" and t.is_contiguous() and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(arr), err_msg=key)
    assert tuple(got["generator.proj.weight"].shape) == (17, 16)


def test_from_torch_state_dict_round_trip(small):
    params, pp = small
    back = TT.from_torch_state_dict(TT.to_torch_state_dict(pp), num_layers=2, device="cpu")
    a, b = tree_paths(pp), tree_paths(back)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, y) in zip(a, b):
        assert y.dtype == torch.float32 and y.is_contiguous(), key
        assert torch.equal(x, y), key


def test_from_torch_state_dict_takes_arrays_as_jax_does(small):
    params, pp = small
    state = JT.to_torch_state_dict(params)          # numpy arrays
    want = JT.from_torch_state_dict(state, num_layers=2)
    got = TT.from_torch_state_dict(state, num_layers=2, device="cpu")
    for (key, x), (_, y) in zip(tree_paths(want), tree_paths(got)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=key)


def test_load_reference_checkpoint_equals_jax(small, tmp_path):
    params, pp = small
    rng = np.random.default_rng(4)
    # a synthetic reference file: the reference's names, torch tensors, fresh values
    state = {k: torch.from_numpy(rng.normal(size=np.asarray(v).shape).astype(np.float32))
             for k, v in JT.to_torch_state_dict(params).items()}
    path = str(tmp_path / "ref.pt")
    torch.save(state, path)
    want = JT.load_reference_checkpoint(path, num_layers=2)
    got = TT.load_reference_checkpoint(path, num_layers=2, device="cpu")
    a, b = tree_paths(want), tree_paths(got)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=key)
    np.testing.assert_array_equal(got["encoder"]["layers"][0]["self_attn"]["q"]["w"].numpy(),
                                  state["encoder.layers.0.self_attn.linears.0.weight"].numpy().T)


def test_converted_weights_follow_torch_linear(small):
    """A converted weight through ``torch.nn.functional.linear`` equals the
    port's (in, out) linear."""
    from onnx_transformer_tpu_torch.ops import layers as TL

    _, pp = small
    state = TT.to_torch_state_dict(pp)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32))
    leaf = pp["encoder"]["layers"][0]["self_attn"]["q"]
    want = torch.nn.functional.linear(x, state["encoder.layers.0.self_attn.linears.0.weight"],
                                      state["encoder.layers.0.self_attn.linears.0.bias"])
    torch.testing.assert_close(TL.linear(x, leaf["w"], leaf["b"]), want, rtol=1e-5, atol=1e-6)


def test_device_defaults_to_the_card(small, monkeypatch):
    _, pp = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.from_torch_state_dict(TT.to_torch_state_dict(pp), num_layers=2)
