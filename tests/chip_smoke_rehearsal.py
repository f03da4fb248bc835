"""The CPU rehearsal of ``chip_smoke.py``'s phases, shared by the
``tests/test_torch_chip_smoke*.py`` files (not collected): on the CPU the
kernel wrappers take their plain versions and count nothing, so each
wrapper is wrapped to count its calls; the CUDA-only timing and profiling
are stubbed.  The ``rehearsal`` fixture installs it for a test, on
``REHEARSAL_THREADS`` torch threads."""

import pytest
import torch

import chip_smoke as C
from onnx_transformer_tpu_torch.models import transformer as PT
from onnx_transformer_tpu_torch.ops.kernels import decode_attention as KA
from onnx_transformer_tpu_torch.ops.kernels import w8a8_matmul as KM

CPU = torch.device("cpu")


def install_rehearsal(monkeypatch):
    """Counting wrappers around the kernel wrappers; the CUDA-only timing
    and profiling stubbed."""
    def counting(fn):
        def wrapper(*args, **kwargs):
            wrapper.launches += 1
            return fn(*args, **kwargs)
        wrapper.launches = 0
        wrapper.__name__ = fn.__name__
        return wrapper

    attn = counting(KA.decode_attention_int8)
    monkeypatch.setattr(KA, "decode_attention_int8", attn)
    monkeypatch.setattr(PT, "decode_attention_int8", attn)
    for name in C.MATMUL_COUNTERS.values():
        monkeypatch.setattr(KM, name, counting(getattr(KM, name)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(C, "cuda_ms", lambda fn, **k: (fn(), 0.0)[1])
    monkeypatch.setattr(C, "profile_decode", lambda *a, **k: None)


# torch threads of a rehearsal: the suite runs several workers on the
# host's cores, and a full-width rehearsal at every core's thread slows
# down by tens of times beside them (the train rehearsal: 10.6 s alone,
# 616 s in a whole run); two threads keep its own time within 2x
REHEARSAL_THREADS = 2


@pytest.fixture
def rehearsal(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(REHEARSAL_THREADS)
    install_rehearsal(monkeypatch)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
