"""The reduction of a profiler trace by the program's own spans, on traces
made by hand."""

import pytest

from benchmark import program, trace
from benchmark.tests.test_bench_trace import RULES, _events

ANN = "user_annotation"


def _span(name, ts, dur):
    return {"cat": ANN, "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts, cat="cuda_runtime"):
    return {"cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _round_events():
    """One round in a window of 200 µs: the benchmark's fft, prove and
    host_copy spans, the program's spans nested inside them, and a device
    event launched in each program span (the all-gather through the
    CUDA driver API, a copy outside every program span)."""
    return [
        _span("bench.window", 0, 200),
        _span("bench.fft", 0, 20), _span("bench.prove", 20, 100),
        _span("bench.host_copy", 120, 80),
        _span("zkp.fft", 1, 18), _span("zkp.prove", 21, 98),
        _span("zkp.commit_open", 22, 38), _span("zkp.open", 23, 7),
        _span("zkp.msm", 31, 28), _span("zkp.bucket_runs", 32, 8),
        _span("zkp.gather", 61, 9), _span("zkp.aggregate", 71, 47),
        # the same ranges on the device's timeline are not the host's
        {"cat": "gpu_user_annotation", "name": "zkp.aggregate", "ts": 0,
         "dur": 200},
        _launch(1, 2), _launch(2, 24), _launch(3, 33), _launch(4, 45),
        _launch(5, 62, "cuda_driver"), _launch(6, 72), _launch(7, 80),
        _launch(8, 121),
        _kernel("fr_butterfly_kernel(int)", 1, 5, 10),
        _kernel("fr_power_tables_kernel(int)", 2, 25, 3),
        _kernel("void cub::DeviceSegmentedRadixSortKernel<1>(int)", 3, 35,
                10),
        _kernel("msm_buckets_kernel(int)", 4, 46, 20),
        _kernel("ncclDevKernel_AllGather_RING_LL(x)", 5, 66, 2),
        _kernel("g1_add_kernel(int)", 6, 74, 2),
        _kernel("g1_msm_fixed_kernel(int)", 7, 90, 5),
        _kernel("Memcpy DtoH (Device -> Pageable)", 8, 122, 2,
                "gpu_memcpy"),
    ]


def _us(table):
    return {k: round(v * 1e6, 6) for k, v in table.items()}


def test_launches_go_to_the_innermost_span():
    spans = program.summarize(_round_events())["spans"]
    assert {k: round(v["device_s"] * 1e6, 6) for k, v in spans.items()} == {
        "fft": 10.0, "prove": 0.0, "commit_open": 0.0, "open": 3.0,
        "msm": 20.0, "bucket_runs": 10.0, "gather": 2.0, "aggregate": 7.0}
    assert {k: v["entered"] for k, v in spans.items()} == dict.fromkeys(
        spans, 1)
    assert [round(t * 1e6, 6) for t in spans["gather"]["nccl"]] == [2.0]
    assert all(not v["nccl"] for k, v in spans.items() if k != "gather")


def test_idle_is_split_along_the_hosts_spans():
    s = program.summarize(_round_events())
    # gaps [0, 5) [15, 25) [28, 35) [45, 46) [68, 74) [76, 90) [95, 122)
    # [124, 200); outside every program span a piece keeps its gap's label
    assert _us(s["idle"]) == {
        "fft": 3.0, "zkp.fft": 8.0, "zkp.prove": 3.0,
        "zkp.commit_open": 2.0, "zkp.open": 4.0, "zkp.msm": 2.0,
        "zkp.bucket_runs": 3.0, "zkp.gather": 2.0, "zkp.aggregate": 40.0,
        "prove": 3.0, "host_copy": 76.0}
    assert {k: round(v["idle_s"] * 1e6, 6)
            for k, v in s["spans"].items()} == {
        "fft": 8.0, "prove": 3.0, "commit_open": 2.0, "open": 4.0,
        "msm": 2.0, "bucket_runs": 3.0, "gather": 2.0, "aggregate": 40.0}
    bench = trace.summarize(_round_events(), RULES)
    assert sum(s["idle"].values()) == pytest.approx(
        bench["window_s"] - bench["busy_s"])


def test_without_program_spans_idle_is_the_benchmarks_gaps():
    events = _events()
    s = program.summarize(events)
    assert s["spans"] == {}
    assert s["idle"] == trace.summarize(events, RULES)["gaps"]
    assert program.summarize([e for e in events
                              if e["name"] != "bench.window"]) is None


def test_program_spans_leave_the_benchmarks_reduction_as_it_was():
    extra = [_span("zkp.fft", 1, 8), _span("zkp.prove", 11, 28),
             _span("zkp.commit_open", 11, 5), _span("zkp.msm", 13, 2),
             _span("zkp.aggregate", 30, 9), _span("zkp.gather", 41, 50)]
    assert trace.summarize(_events() + extra, RULES) == trace.summarize(
        _events(), RULES)

