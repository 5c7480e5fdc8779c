"""The device's busy time, idle gaps and top operations from a
``torch.profiler`` trace of whole steps.

The profiler records the device's activity only (CUPTI: kernels, copies,
sets and the CUDA runtime calls that launch them): recording every host
operation as well costs the host ~20 us an operation and doubled a
launch-bound step, so the idle share would measure the profiler. The
trace is exported as Chrome JSON under ``TMPDIR``, read and deleted. Busy
time is the union of the device's operation intervals inside the traced
window, so operations that overlap count once; the window runs between the
two synchronisations around the traced steps (where the trace holds no
runtime calls, the host clock's span of them). An idle gap is named by the
runtime call the host was in at its middle, else as time between launches
after the device's last operation.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNC = ("cudaDeviceSynchronize", "cudaStreamSynchronize")
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals: overlapping or touching ones become one."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[dict], wall_s: float = 0.0) -> Dict[str, object]:
    """busy_s, window_s and the breakdown of a Chrome trace's events (times
    in microseconds): the window from the end of the first synchronisation
    to the end of the last; without them, ``wall_s`` over the device's
    operations as they are."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b, e["name"]))
        elif e.get("cat") in HOST_CATS:
            host.append((a, b, e["name"]))
    syncs = sorted(b for a, b, name in host if name in SYNC)
    if not dev:
        return {}
    if len(syncs) >= 2:
        t0, t1 = syncs[0], syncs[-1]
    elif wall_s > 0:
        t0 = min(a for a, _, _ in dev)
        t1 = t0 + wall_s * 1e6
    else:
        return {}
    by_name = defaultdict(float)
    clipped = []
    for a, b, name in dev:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            clipped.append((a, b))
            by_name[name] += b - a
    merged = union(clipped)
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    ends = sorted((b, name) for a, b, name in dev)

    def doing(a: float, b: float) -> str:
        t = (a + b) / 2
        inner = [(y - x, name) for x, y, name in host if x <= t <= y]
        if inner:
            return "host: " + min(inner)[1]
        before = [name for end, name in ends if end <= a]
        return "host: between launches, after " + (before[-1][:120] if before else "the window's start")

    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "breakdown": {
            "device_ops": [[name[:160], us / 1e6] for name, us in ops],
            "idle_gaps": [[doing(a, b), (b - a) / 1e6] for a, b in gaps[:TOP]],
        },
    }


def profile(fn: Callable[[], None]) -> Dict[str, object]:
    """Run ``fn`` (whole steps, ending in a synchronisation) under the
    profiler and summarize its trace; {} when the trace holds no device
    operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    if not torch.cuda.is_available():
        fn()
        return {}
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()  # the window's start
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, wall)
