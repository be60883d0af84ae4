"""The reduction of a profiler trace, on a trace made by hand."""

import os
import types

import pytest

from benchmark import trace
from benchmark.spec import HERE, Spec

RULES = Spec(os.path.dirname(HERE)).layer_rules()


def _events():
    ann = "user_annotation"
    return [
        {"cat": ann, "name": "bench.window", "ts": 0, "dur": 100},
        {"cat": ann, "name": "bench.fft", "ts": 0, "dur": 10},
        {"cat": ann, "name": "bench.prove", "ts": 10, "dur": 30},
        {"cat": ann, "name": "bench.host_copy", "ts": 40, "dur": 60},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 14,
         "args": {"correlation": 3}},
        {"cat": "kernel", "name": "fr_butterfly_kernel(int, int)", "ts": 5,
         "dur": 20, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "void msm_buckets_kernel<4>(int*)",
         "ts": 25, "dur": 30, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "void fr_binary_kernel<0>(int*)", "ts": 55,
         "dur": 5, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "ncclDevKernel_AllGather(x)", "ts": 58,
         "dur": 4, "args": {"correlation": 9}},
        {"cat": "kernel", "name": "late", "ts": 99, "dur": 10,
         "args": {"correlation": 10}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 15,
         "args": {"correlation": 4}},
        {"cat": "kernel", "name": "void cub::DeviceRadixSortKernel<1>(int)",
         "ts": 60, "dur": 1, "args": {"correlation": 4}},
    ]


def test_layers_busy_and_gaps():
    s = trace.summarize(_events(), RULES)
    assert abs(s["window_s"] - 100e-6) < 1e-12
    # busy: [5, 62] and [99, 100] (the last kernel clipped to the window)
    assert abs(s["busy_s"] - 58e-6) < 1e-12
    layers = {k: round(v * 1e6, 6) for k, v in s["layers"].items()}
    assert layers == {"ntt": 20.0, "msm": 31.0, "fr_open": 5.0,
                      "collective": 4.0, "other": 1.0}
    gaps = {k: round(v * 1e6, 6) for k, v in s["gaps"].items()}
    # idle [0, 5) while the host was in fft, [62, 99) in host_copy
    assert gaps == {"fft": 5.0, "host_copy": 37.0}
    assert round(s["ops"]["msm_buckets_kernel<4>"] * 1e6, 6) == 30.0


def test_a_layer_that_asks_keeps_each_kernels_time():
    s = trace.summarize(_events(), RULES)
    assert {k: [round(v * 1e6, 6) for v in q]
            for k, q in s["each"].items()} == {"collective": [4.0]}


def _ctx(*seqs, rounds=2):
    return types.SimpleNamespace(rounds=rounds, summaries=[
        {"each": {"collective": list(q)} if q else {},
         "layers": {"collective": sum(q)}} for q in seqs])


def test_collective_ms_takes_each_collectives_least_rank():
    read = Spec(os.path.dirname(HERE)).reader("collective_ms")
    # rank 0 arrived last at the first collective, rank 1 at the second
    assert read(_ctx([1e-3, 9e-3], [7e-3, 2e-3])) == pytest.approx(1.5)
    # counts that differ: the least rank's total
    assert read(_ctx([1e-3, 9e-3], [4e-3])) == pytest.approx(2.0)
    assert read(_ctx([], [])) is None


def test_no_window_no_summary():
    assert trace.summarize([e for e in _events()
                            if e["name"] != "bench.window"],
                           RULES) is None
