"""The idle union over overlapping intervals and the trace's summary."""
from perfbench.lib import trace


def test_union_merges_overlaps_and_touches():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4), (10, 11)]) == [(0, 4), (5, 7), (10, 11)]
    assert trace.union([]) == []
    assert trace.union([(0, 10), (2, 3)]) == [(0, 10)]


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summary_counts_overlaps_once():
    events = [
        _ev("cudaDeviceSynchronize", "cuda_runtime", -5.0, 5.0),  # the window: 0..100
        _ev("gemm", "kernel", 10.0, 30.0),      # 10..40
        _ev("copy", "gpu_memcpy", 20.0, 30.0),  # 20..50, overlaps the gemm
        _ev("tail", "kernel", 90.0, 20.0),      # 90..110, clipped to the window
        _ev("cudaMemcpyAsync", "cuda_runtime", 60.0, 20.0),
        _ev("before", "kernel", -20.0, 10.0),   # outside the window
        _ev("cudaDeviceSynchronize", "cuda_runtime", 95.0, 5.0),
    ]
    s = trace.summarize(events)
    assert abs(s["busy_s"] - 50e-6) < 1e-12  # 10..50 and 90..100
    assert abs(s["window_s"] - 100e-6) < 1e-12
    gaps = s["breakdown"]["idle_gaps"]
    assert [round(g[1] * 1e6, 6) for g in gaps] == [40.0, 10.0]
    assert gaps[0][0] == "host: cudaMemcpyAsync"
    assert gaps[1][0] == "host: between launches, after before"
    assert s["breakdown"]["device_ops"][0] == ["gemm", 30e-6]


def test_without_runtime_calls_the_host_span_is_the_window():
    s = trace.summarize([_ev("gemm", "kernel", 10.0, 30.0)], wall_s=60e-6)
    assert abs(s["window_s"] - 60e-6) < 1e-12 and abs(s["busy_s"] - 30e-6) < 1e-12


def test_no_device_operation_gives_nothing():
    assert trace.summarize([_ev("cudaDeviceSynchronize", "cuda_runtime", 0.0, 10.0)] * 2) == {}
