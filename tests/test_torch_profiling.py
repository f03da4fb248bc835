"""Port of utils/profiling.py: the counterparts of tests/test_profiling.py,
the analytic FLOPs and the roofline fraction equal to JAX's (the peak
passed explicitly; the port's default is the H100 SXM's dense int8 rate),
the span's errors propagating, and the torch.profiler trace written."""

import os

import numpy as np
import pytest
import torch

from onnx_transformer_tpu.utils import profiling as JP
from onnx_transformer_tpu_torch.utils import profiling as P


def test_span_records():
    sink = {}
    with P.span("work", sink):
        _ = sum(range(1000))
    assert len(sink["work"]) == 1 and sink["work"][0] >= 0
    with P.span("work", sink, sync=False):
        pass
    assert len(sink["work"]) == 2


def test_span_does_not_swallow_errors():
    sink = {}
    with pytest.raises(ZeroDivisionError):
        with P.span("bad", sink):
            _ = 1 / 0
    assert "bad" not in sink


def test_timer_measures():
    x = torch.ones((64, 64))
    t = P.Timer(warmup=1, iters=2).measure(lambda a: a @ a, x)
    assert t > 0


def test_throughput_meter():
    m = P.ThroughputMeter()
    m.add(100)
    assert m.rate() > 0
    m.reset()
    assert m.tokens == 0


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("dims", [(512, 2048, 6, 72, 72, 4444), (32, 64, 2, 9, 12, 29)])
def test_flops_equal_jax(dims, decode):
    assert P.transformer_flops_per_token(*dims, decode=decode) == \
        JP.transformer_flops_per_token(*dims, decode=decode)


def test_flops_and_roofline():
    f = P.transformer_flops_per_token(512, 2048, 6, 72, 72, 4444)
    assert f > 2 * 6 * (8 * 512 * 512 + 2 * 512 * 2048)  # at least the linears
    frac = P.roofline_fraction(1e6, f)
    assert 0 < frac < 1
    for peak in (394e12, 1979e12):
        assert P.roofline_fraction(1e6, f, peak) == JP.roofline_fraction(1e6, f, peak)
    # the port's default peak is the H100's dense int8 rate, the JAX one a v5e's
    assert P.roofline_fraction(1e6, f) == P.roofline_fraction(1e6, f, 1979e12)
    assert np.isclose(JP.roofline_fraction(1e6, f) / P.roofline_fraction(1e6, f),
                      1979 / 394)


def test_trace_writes_a_profile(tmp_path):
    with P.trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in files), files
