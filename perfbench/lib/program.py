"""The device's time, launches and idle gaps of a traced run put down to the
program's own spans (``repro_torch.utils.trace``).

``profile(fn)`` is ``lib/trace.py::profile`` with the traced steps run
inside the program's ``recording()``: the same summary, plus the join under
its ``program`` key.

The spans are stamped on the host by the program's clock, the trace's
events by the profiler's. The two are tied at the synchronisations around
the traced steps: the program's stamp taken right after each
``torch.cuda.synchronize()`` returns stands for the end of that
``cudaDeviceSynchronize`` in the trace: a second one at the window's start
(the first call under the profiler returns ~3.5 ms after the trace ends it)
and the one at its end. The profiler synchronises too, as it stops, so of
the trace's synchronisations the tie takes the two whose ends lie as far
apart as the two stamps; the second corrects any drift between the clocks.

Each device operation (kernel, copy or set) is put down to the innermost
span that was open on the host when its launch was issued: the runtime or
driver call with the operation's ``args.correlation``, at the middle of that
call. Which host thread made the call does not matter (autograd's device
thread runs the backward while the program's thread sits in its backward
span). An operation counts once: its time is the part of its interval, in
the window, that no earlier operation covers, so the operations' times add
up to the trace's busy time. An idle gap of the device is put down to the
span innermost on the host at each moment of it.

For each span name: ``count``; ``host_ms``, the spans' summed host time,
and ``host_ms_median``; ``device_ms``, ``launches`` and ``idle_ms`` of the
operations and gaps under the span or any span inside it; ``self_*`` the
same under the span itself. ``outside`` holds what falls under no span.
``items`` holds every span with its own numbers and meta, in the order
they started.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Sequence

from perfbench.lib.trace import DEVICE_CATS, HOST_CATS, SYNC, TOP, summarize, union

OUTSIDE = "outside any span"


def profile(fn: Callable[[], None]) -> Dict[str, object]:
    """Run ``fn`` (whole steps, ending in a synchronisation) under the
    profiler and inside the program's ``recording()``; the trace's summary
    with the join under ``program``. {} when the trace holds no device
    operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    from repro_torch.utils import trace as spans_of

    if not torch.cuda.is_available():
        fn()
        return {}
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof, spans_of.recording() as spans:
        torch.cuda.synchronize()  # the window's start
        torch.cuda.synchronize()  # the first call under the profiler returns ~ms late: tie the clocks here
        stamps = [time.perf_counter_ns()]
        fn()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter_ns())
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = summarize(events, (stamps[1] - stamps[0]) / 1e9)
    if out:
        out["program"] = join(events, spans, stamps)
    return out


def _spans(spans) -> List[dict]:
    return sorted(({"id": s.id, "name": s.name, "parent": s.parent, "root": s.root, "start": s.start,
                    "end": s.end, "meta": dict(s.meta)} for s in spans), key=lambda s: (s["start"], s["id"]))


def clock(events: Sequence[dict], stamps: Sequence[int]):
    """(to_us, drift): ``to_us(ns)`` maps the program's clock onto the
    trace's microseconds through the ends of the device synchronisations
    that ``stamps`` (the first and the last) were taken after; ``drift`` is
    the rate between the two clocks less 1. With one stamp or one
    synchronisation, the first of each. None when the trace holds no
    synchronisation."""
    ends = sorted(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") == SYNC[0])
    if not ends:
        return None, 0.0
    s0, t0, rate = stamps[0], ends[0], 1.0
    span = (stamps[-1] - s0) / 1e3
    if len(ends) > 1 and span > 0:
        t0, t1 = min(((a, b) for i, a in enumerate(ends) for b in ends[i + 1:]),
                     key=lambda ab: abs(ab[1] - ab[0] - span))
        rate = (t1 - t0) / span
    return (lambda ns: t0 + rate * (ns - s0) / 1e3), rate - 1.0


def _timeline(spans: List[dict]):
    """(starts, owners): from ``starts[i]`` on, the innermost open span is
    ``owners[i]`` (an index into ``spans``, -1 for none)."""
    points = []
    for i, s in enumerate(spans):
        if s["b"] <= s["a"]:
            continue
        points.append((s["a"], 1, i))
        points.append((s["b"], 0, i))  # at one time, closes before opens
    points.sort()
    starts, owners, stack = [float("-inf")], [-1], []
    for t, opens, i in points:
        if opens:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
        owner = stack[-1] if stack else -1
        if starts[-1] == t:
            owners[-1] = owner
        elif owners[-1] != owner:
            starts.append(t)
            owners.append(owner)
    return starts, owners


def join(events: Sequence[dict], spans, stamps: Sequence[int]) -> Dict[str, object]:
    """The join of a Chrome trace's events (times in microseconds) with
    the program's finished spans; ``stamps`` are the program's clock at the
    window's first and last synchronisation. {} without a span, a
    synchronisation or a device operation."""
    to_us, drift = clock(events, stamps)
    if to_us is None or not spans:
        return {}
    items = _spans(spans)
    for s in items:
        s["a"], s["b"] = to_us(s["start"]), to_us(s["end"])
    launch, dev, syncs = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b, corr))
        elif e.get("cat") in HOST_CATS:
            if corr is not None:
                launch[corr] = (a + b) / 2
            if e.get("name") in SYNC:
                syncs.append(b)
    if not dev or len(syncs) < 2:
        return {}
    w0, w1 = min(syncs), max(syncs)
    starts, owners = _timeline(items)
    n = len(items)
    self_dev, self_launch, self_idle = [0.0] * (n + 1), [0] * (n + 1), [0.0] * (n + 1)  # [-1]: outside
    unmatched, covered, clipped = 0, w0, []
    for a, b, corr in sorted(dev, key=lambda d: d[:2]):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        t = launch.get(corr)
        if t is None:
            unmatched += 1
            owner = -1
        else:
            owner = owners[bisect.bisect_right(starts, t) - 1]
        self_dev[owner] += max(0.0, b - max(a, covered))
        self_launch[owner] += 1
        covered = max(covered, b)
    merged = union(clipped)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    for a, b in gaps:
        j = bisect.bisect_right(starts, a) - 1
        while j < len(starts) and starts[j] < b:
            lo = max(a, starts[j])
            hi = min(b, starts[j + 1]) if j + 1 < len(starts) else b
            if hi > lo:
                self_idle[owners[j]] += hi - lo
            j += 1

    index = {s["id"]: i for i, s in enumerate(items)}
    total_dev, total_launch, total_idle = self_dev[:n], self_launch[:n], self_idle[:n]
    for i in sorted(range(n), key=lambda i: -items[i]["id"]):  # a child before its parent
        p = index.get(items[i]["parent"])
        if p is not None:
            total_dev[p] += total_dev[i]
            total_launch[p] += total_launch[i]
            total_idle[p] += total_idle[i]
    by_name: Dict[str, dict] = {}
    host: Dict[str, list] = {}
    out_items = []
    for i, s in enumerate(items):
        ms = (s["end"] - s["start"]) / 1e6
        host.setdefault(s["name"], []).append(ms)
        g = by_name.setdefault(s["name"], dict.fromkeys(
            ("count", "host_ms", "device_ms", "self_device_ms", "launches", "self_launches", "idle_ms",
             "self_idle_ms"), 0))
        g["count"] += 1
        g["host_ms"] += ms
        g["device_ms"] += total_dev[i] / 1e3
        g["self_device_ms"] += self_dev[i] / 1e3
        g["launches"] += total_launch[i]
        g["self_launches"] += self_launch[i]
        g["idle_ms"] += total_idle[i] / 1e3
        g["self_idle_ms"] += self_idle[i] / 1e3
        out_items.append({"id": s["id"], "name": s["name"], "parent": s["parent"], "root": s["root"],
                          "meta": s["meta"], "host_ms": ms, "device_ms": total_dev[i] / 1e3,
                          "self_device_ms": self_dev[i] / 1e3, "launches": total_launch[i]})
    for name, g in by_name.items():
        g["host_ms_median"] = statistics.median(host[name])
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        owner = owners[bisect.bisect_right(starts, (a + b) / 2) - 1]
        named.append([items[owner]["name"] if owner >= 0 else OUTSIDE, (b - a) / 1e6])
    return {
        "spans": by_name,
        "outside": {"device_ms": self_dev[-1] / 1e3, "launches": self_launch[-1],
                    "idle_ms": self_idle[-1] / 1e3},
        "busy_ms": sum(b - a for a, b in merged) / 1e3,
        "window_ms": (w1 - w0) / 1e3,
        "unmatched": unmatched,
        "drift": drift,
        "idle_gaps": named,
        "items": out_items,
    }


def per_root(prog: dict, name: str, field: str, root: str):
    """``field`` of the spans called ``name`` over the number of ``root``
    spans (a round, a decode call); None where either is missing."""
    spans = (prog or {}).get("spans") or {}
    if name not in spans or not spans.get(root, {}).get("count"):
        return None
    return spans[name][field] / spans[root]["count"]


def table(prog: dict) -> str:
    """One line a span name, the self columns first: what each layer of
    the program holds of the traced steps' device time and idle time."""
    lines = [f"spans: busy {prog['busy_ms']:.3f} ms of {prog['window_ms']:.3f}, "
             f"unmatched launches {prog['unmatched']}, clock drift {prog['drift']:.3e}",
             "span count host_ms self_device_ms self_launches self_idle_ms device_ms launches idle_ms"]
    for name, g in sorted(prog["spans"].items(), key=lambda kv: -kv[1]["device_ms"]):
        lines.append(f"{name} {g['count']} {g['host_ms']:.3f} {g['self_device_ms']:.3f} {g['self_launches']} "
                     f"{g['self_idle_ms']:.3f} {g['device_ms']:.3f} {g['launches']} {g['idle_ms']:.3f}")
    o = prog["outside"]
    lines.append(f"{OUTSIDE.replace(' ', '_')} - - {o['device_ms']:.3f} {o['launches']} {o['idle_ms']:.3f} - - -")
    lines += [f"idle gap {s:.6f} s under {name}" for name, s in prog["idle_gaps"]]
    return "\n".join("program " + x for x in lines)
