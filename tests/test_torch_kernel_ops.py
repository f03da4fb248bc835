"""K1-K8 as registered PyTorch operators (``torch.ops.otk.*``).

- ``torch.library.opcheck`` passes for each of the eight operators at small
  shapes on the CPU (schema, autograd registration, fake tensors, and the
  AOT dispatch with dynamic shapes).
- Each fake implementation gives the real outputs' shapes, dtypes and
  strides; the wrappers' argument checks refuse bad arguments, on real and
  on fake tensors; on the CPU the operators run the plain versions, equal
  to calling them directly, and count no launch.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from onnx_transformer_tpu_torch.ops.kernels import decode_attention as KA
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM
from onnx_transformer_tpu_torch.quant.core import pack_int4

ROWS = ("quant_w8a8_matmul_qout", "quant_w8a8_matmul_q8", "quant_w8a8_matmul")
PACKED = ("quant_w4a8_matmul_qout", "quant_w4a8_matmul_q8", "quant_w4a8_matmul")
OPS = ROWS + PACKED + ("w8a8_matmul", "decode_attention_int8")
PLAIN = {"quant_w8a8_matmul_qout": KM.quant_w8a8_matmul_qout_ref,
         "quant_w8a8_matmul_q8": KM.quant_w8a8_matmul_q8_ref,
         "quant_w8a8_matmul": KM.quant_w8a8_matmul_ref,
         "quant_w4a8_matmul_qout": KM.quant_w4a8_matmul_qout_ref,
         "quant_w4a8_matmul_q8": KM.quant_w4a8_matmul_q8_ref,
         "quant_w4a8_matmul": KM.quant_w4a8_matmul_ref,
         "w8a8_matmul": KM.w8a8_matmul_ref,
         "decode_attention_int8": KA.decode_attention_int8_ref}


def _args(name: str, m: int = 6, k: int = 64, n: int = 48, seed: int = 0) -> tuple:
    """Operator arguments from a numpy seed: x [m, k] (int8 rows and scales
    for K5), weights [k, n] (packed int4 [k/2, n] for K6-K8), sw and b [n];
    for K3 a [3, 9, 32] cache over 4 heads with a ragged mask."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    if name == "decode_attention_int8":
        b, s, d = 3, 9, 32
        mask = rng.random((b, s)) > 0.3
        mask[:, 0] = True
        return (t(rng.normal(size=(b, d)).astype(np.float32)),
                t(rng.integers(-127, 128, (b, s, d)).astype(np.int8)),
                t(rng.uniform(1e-3, 1e-2, (b, s)).astype(np.float32)),
                t(rng.integers(-127, 128, (b, s, d)).astype(np.int8)),
                t(rng.uniform(1e-3, 1e-2, (b, s)).astype(np.float32)), t(mask), 4, True)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    if name in PACKED:
        w = pack_int4(t(rng.integers(-8, 8, (k, n)).astype(np.int8))).numpy()
    sw = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    if name == "w8a8_matmul":
        return (t(rng.integers(-127, 128, (m, k)).astype(np.int8)),
                t(rng.uniform(1e-3, 5e-2, m).astype(np.float32)), t(w), t(sw), t(b))
    return t(rng.normal(size=(m, k)).astype(np.float32)), t(w), t(sw), t(b)


def _op(name):
    return getattr(torch.ops.otk, name)


def test_the_namespace_holds_the_eight_operators():
    assert KM.OP_NAMESPACE == "otk"
    for name in OPS:
        assert _op(name).default.namespace == "otk"


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    result = torch.library.opcheck(_op(name), _args(name))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", OPS)
def test_fake_outputs_match_real(name):
    args = _args(name)
    real = _op(name)(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = _op(name)(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype, f.stride()) for f in fake] == [
        (r.shape, r.dtype, r.stride()) for r in real]


@pytest.mark.parametrize("name", OPS)
def test_cpu_operator_is_the_plain_version_and_counts_nothing(name):
    args = _args(name, seed=1)
    holder = KA.decode_attention_int8 if name == "decode_attention_int8" else getattr(KM, name)
    before = holder.launches
    got, want = _op(name)(*args), PLAIN[name](*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the wrapper too, on the same arguments
    wrapper_out = holder(*args)
    wrapper_out = wrapper_out if isinstance(wrapper_out, tuple) else (wrapper_out,)
    for g, w in zip(wrapper_out, want):
        assert torch.equal(g.reshape(w.shape), w)
    assert holder.launches == before


def _bad_calls():
    x, w, sw, b = _args("quant_w8a8_matmul_qout")
    _, wp, _, _ = _args("quant_w4a8_matmul_qout")
    xq, sx, _, _, _ = _args("w8a8_matmul")
    q, kq, ks, vq, vs, mask, h, quant = _args("decode_attention_int8")
    return [
        ("int8 weights for K1", KM.quant_w8a8_matmul_qout, (x, w.float(), sw, b), "weights"),
        ("short sw", KM.quant_w8a8_matmul_q8, (x, w, sw[:-1], b), "sw must be"),
        ("f64 x", KM.quant_w8a8_matmul_qout, (x.double(), w, sw, b), "float32"),
        ("K over 2048", KM.quant_w8a8_matmul_qout,
         (torch.zeros(2, 2050), torch.zeros(2050, 8, dtype=torch.int8), sw[:8], b[:8]),
         "within"),
        ("odd K packed", KM.quant_w4a8_matmul_qout,
         (torch.zeros(2, 63), torch.zeros(31, 48, dtype=torch.uint8), sw, b), "even"),
        ("int8 for packed", KM.quant_w4a8_matmul, (x, w, sw, b), "weights"),
        ("f32 xq", KM.w8a8_matmul, (xq.float(), sx, w, sw, b), "int8"),
        ("sx shape", KM.w8a8_matmul, (xq, sx[:-1], w, sw, b), "sx must be"),
        ("heads", KA.decode_attention_int8, (q, kq, ks, vq, vs, mask, 5, quant), "heads"),
        ("mask", KA.decode_attention_int8, (q, kq, ks, vq, vs, mask[:, :-1], h, quant),
         "mask must be"),
        ("vq dtype", KA.decode_attention_int8, (q, kq, ks, vq.float(), vs, mask, h, quant),
         "vq must be"),
    ]


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
@pytest.mark.parametrize("case", [label for label, *_ in _bad_calls()])
def test_wrappers_refuse_bad_arguments(case, fake):
    _, fn, args, match = next(call for call in _bad_calls() if call[0] == case)
    if not fake:
        with pytest.raises(ValueError, match=match):
            fn(*args)
        return
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with pytest.raises(ValueError, match=match):
            fn(*fake_args)
