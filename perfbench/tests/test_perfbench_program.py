"""The join of a device trace with the program's spans (``lib/program.py``)
on synthetic Chrome traces, and the readers of the metrics it feeds
(``perfbench/metrics/``, not yet listed in ``BENCHMARK.json``)."""
import types

import pytest

from perfbench import run as bench
from perfbench.lib import counts, manifest, peaks, program

BASE_NS = 7_000_000_000_000  # the program's clock reads another origin than the trace's
DRIFT = 1e-4  # and runs a little faster
NEW = ("forward_ms", "backward_ms", "sketch_draw_ms", "sketch_project_ms", "launches.train",
       "decode_gather_ms", "decode_step_host_ms", "launches.decode", "decode_attn_roofline.trace")


def ns(us):
    """The program's clock at the trace's ``us``."""
    return BASE_NS + round(us * 1e3 * (1 + DRIFT))


def _ev(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launched(name, corr, at, start, end, tid=1, cat="kernel"):
    """A launch call at ``at`` on host thread ``tid`` and its operation."""
    return [_ev("cudaLaunchKernel", "cuda_runtime", at, 2.0, corr, tid), _ev(name, cat, start, end - start, corr, 7)]


class Spans:
    def __init__(self):
        self.kept, self.stack, self.n = [], [], 0

    def open(self, name, a, b, **meta):
        """A span from ``a`` to ``b`` (trace microseconds); nest by calling
        inside ``with``."""
        self.n += 1
        parent = self.stack[-1] if self.stack else None
        s = types.SimpleNamespace(name=name, id=self.n, parent=parent.id if parent else None,
                                  root=self.stack[0].id if self.stack else self.n,
                                  start=ns(a), end=ns(b), meta=meta)
        self.kept.append(s)
        return self._ctx(s)

    def _ctx(self, s):
        outer = self

        class Ctx:
            def __enter__(self):
                outer.stack.append(s)

            def __exit__(self, *exc):
                outer.stack.pop()
        return Ctx()


def train_trace():
    """A round 10..900 us: forward 20..200, backward 300..600 (its launches
    from a second host thread, two operations that overlap), the sketch
    650..880 with a draw and a product; a copy before the round and an
    operation with no launch in the trace after it. The window is 0..1000."""
    sp = Spans()
    with sp.open("train.round", 10, 900):
        sp.open("train.forward", 20, 200)
        sp.open("train.backward", 300, 600)
        with sp.open("sketch", 650, 880):
            sp.open("sketch.draw", 660, 700)
            sp.open("sketch.project", 710, 760)
    events = [_ev("cudaDeviceSynchronize", "cuda_runtime", -5.0, 5.0, 100),
              _ev("cudaDeviceSynchronize", "cuda_runtime", 995.0, 5.0, 101)]
    events += launched("copy", 6, 5, 7, 9, cat="gpu_memcpy")
    events += launched("fwd", 1, 25, 30, 100)
    events += launched("bwd", 2, 310, 320, 500, tid=2)
    events += launched("bwd2", 3, 314, 450, 550, tid=2)
    events += launched("draw", 4, 665, 670, 690)
    events += launched("proj", 5, 715, 720, 740)
    events += launched("tail", 7, 890, 895, 990)
    events.append(_ev("orphan", "kernel", 992, 2, 8))
    return events, sp.kept, [ns(0), ns(1000)]


def close(a, b):
    return a == pytest.approx(b, abs=1e-6)


def test_join_puts_each_operation_and_gap_under_its_span():
    events, spans, stamps = train_trace()
    p = program.join(events, spans, stamps)
    s = p["spans"]
    assert close(p["drift"], 1 / (1 + DRIFT) - 1)
    # device time in ms; the backward's two operations overlap by 50 us and count once
    assert close(s["train.forward"]["device_ms"], 0.070)
    assert close(s["train.backward"]["device_ms"], 0.230) and s["train.backward"]["launches"] == 2
    assert close(s["sketch.draw"]["device_ms"], 0.020) and close(s["sketch.project"]["device_ms"], 0.020)
    assert close(s["sketch"]["device_ms"], 0.040) and close(s["sketch"]["self_device_ms"], 0.0)
    assert close(s["train.round"]["self_device_ms"], 0.095) and s["train.round"]["launches"] == 6
    assert close(s["train.round"]["device_ms"], 0.070 + 0.230 + 0.040 + 0.095)
    assert p["outside"]["launches"] == 2 and close(p["outside"]["device_ms"], 0.004) and p["unmatched"] == 1
    # the join adds up: every operation once, under one span or outside
    own = sum(g["self_device_ms"] for g in s.values()) + p["outside"]["device_ms"]
    assert close(own, p["busy_ms"]) and close(p["busy_ms"], 0.439)
    # idle: each gap under the span innermost on the host at each moment
    want = {"train.round": 175, "train.forward": 110, "train.backward": 70, "sketch": 140,
            "sketch.draw": 20, "sketch.project": 30}
    for name, us in want.items():
        assert close(s[name]["self_idle_ms"], us / 1e3), name
    assert close(p["outside"]["idle_ms"], 0.016)
    assert close(s["train.round"]["idle_ms"], (1000 - 439 - 16) / 1e3)
    assert close(sum(g["self_idle_ms"] for g in s.values()) + p["outside"]["idle_ms"], 1.0 - 0.439)
    assert p["idle_gaps"][0] == ["train.round", pytest.approx(220e-6)]  # 100..320: its middle, 210
    assert close(s["train.forward"]["host_ms"], 0.180 * (1 + DRIFT))
    assert [i["name"] for i in p["items"]][:2] == ["train.round", "train.forward"]
    assert "program train.forward 1" in program.table(p)


def test_the_clock_ties_at_the_steps_own_synchronisations():
    """The profiler's own synchronisations, as it starts and as it stops,
    and a stream synchronisation inside the steps move neither end of the tie."""
    events, _, stamps = train_trace()
    to_us, drift = program.clock(events, stamps)
    more = events + [_ev("cudaDeviceSynchronize", "cuda_runtime", -3000.0, 5.0, 102),
                     _ev("cudaDeviceSynchronize", "cuda_runtime", 1100.0, 800.0, 103),
                     _ev("cudaStreamSynchronize", "cuda_runtime", 990.0, 9.0, 104)]
    to_us2, drift2 = program.clock(more, stamps)
    assert close(drift, drift2) and close(to_us(ns(500)), 500.0) and close(to_us2(ns(500)), 500.0)
    # one synchronisation: the start's tie alone
    to_us1, drift1 = program.clock(events[:1], stamps)
    assert drift1 == 0.0 and close(to_us1(ns(0)), 0.0)


def test_join_needs_the_window_and_a_device_operation():
    events, spans, stamps = train_trace()
    assert program.join([e for e in events if e["name"] != "cudaDeviceSynchronize"], spans, stamps) == {}
    assert program.join([e for e in events if e["cat"] == "cuda_runtime"], spans, stamps) == {}
    assert program.join(events, [], stamps) == {}


def test_join_of_the_programs_own_recording():
    """The program's finished spans carry what the join reads, and an
    operation launched while one was open lands under it."""
    from repro_torch.utils import trace

    with trace.recording() as spans:
        with trace.span("train.round"):
            with trace.span("sketch.draw"):
                pass
    start = {s.name: s.start for s in spans}
    t0 = min(start.values())
    stamps = [t0 - 10_000, max(s.end for s in spans) + 10_000]  # 10 us before and after, on the trace at 0
    at = (start["sketch.draw"] - stamps[0]) / 1e3
    end = (stamps[1] - stamps[0]) / 1e3
    events = [_ev("cudaDeviceSynchronize", "cuda_runtime", -5.0, 5.0, 100),
              _ev("cudaDeviceSynchronize", "cuda_runtime", end - 5.0, 5.0, 101)]
    events += launched("draw", 1, at, at + 1, at + 2)
    p = program.join(events, spans, stamps)
    assert p["spans"]["sketch.draw"]["launches"] == 1 and p["spans"]["train.round"]["launches"] == 1
    assert p["spans"]["train.round"]["self_launches"] == 0 and p["unmatched"] == 0


def test_profile_without_a_card_runs_the_steps_once(monkeypatch):
    """As ``lib/trace.py::profile``: no card, no trace, no summary."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    assert program.profile(lambda: ran.append(1)) == {} and ran == [1]


def test_train_readers():
    events, spans, stamps = train_trace()
    rec = {"kind": "train_tokens", "trace": {"program": program.join(events, spans, stamps)}}
    read = {n: manifest.reader(n).read(rec) for n in NEW[:5]}
    assert read == {"forward_ms": pytest.approx(0.07), "backward_ms": pytest.approx(0.23),
                    "sketch_draw_ms": pytest.approx(0.02), "sketch_project_ms": pytest.approx(0.02),
                    "launches.train": 6}
    assert all(manifest.reader(n).read(rec) is None for n in NEW[5:])


def decode_trace():
    """A decode call 1..590 us of the window 0..600: a gather, two fleet steps of two layers'
    attention each, rows at positions (3, 5) then (4, 6)."""
    sp = Spans()
    events = [_ev("cudaDeviceSynchronize", "cuda_runtime", -5.0, 5.0, 100),
              _ev("cudaDeviceSynchronize", "cuda_runtime", 595.0, 5.0, 101)]
    corr = iter(range(1, 100))
    with sp.open("decode.call", 1, 590, rows=2, lanes=4, steps=2):
        sp.open("decode.gather", 2, 50)
        events += launched("gather", next(corr), 10, 20, 60)
        for i, t in enumerate((100, 300)):
            with sp.open("decode.step", t, t + 150, positions=[3 + i, 5 + i]):
                for layer in range(2):
                    a = t + 10 + 50 * layer
                    sp.open("decode.attention", a, a + 20)
                    events += launched("decode_attention_kernel", next(corr), a + 5, a + 30, a + 40)
                    events += launched("gemv", next(corr), a + 25, a + 40, a + 60)
    return events, sp.kept, [ns(0), ns(600)]


def test_decode_readers(tiny):
    events, spans, stamps = decode_trace()
    rec = {"kind": "decode_tokens", "config": tiny, "lanes": 4,
           "trace": {"program": program.join(events, spans, stamps)}}
    read = {n: manifest.reader(n).read(rec) for n in NEW[5:]}
    assert read["decode_gather_ms"] == pytest.approx(0.040)
    assert read["launches.decode"] == 4
    assert read["decode_step_host_ms"] == pytest.approx(0.150 * (1 + DRIFT))
    nbytes = sum(counts.attention_call_bytes(tiny, 4, p + 1) for p in (3, 5, 3, 5, 4, 6, 4, 6))
    want = 100.0 * nbytes / peaks.HBM_BYTES_PER_S / (4 * 10e-6)
    assert read["decode_attn_roofline.trace"] == pytest.approx(want)
    assert all(manifest.reader(n).read(rec) is None for n in NEW[:5])


def test_readers_read_nothing_without_the_program_join():
    """A CPU run (no profiler trace) and a program without spans: no value."""
    for rec in ({"kind": "train_tokens", "trace": {}}, {"kind": "decode_tokens", "trace": {}, "lanes": 4},
                {"kind": "train_tokens", "trace": {"busy_s": 1.0, "window_s": 2.0}}):
        assert all(manifest.reader(n).read(rec) is None for n in NEW)


def test_cpu_traced_decode_run_has_no_new_metric(tiny, one_thread):
    out = bench.run("granite-3-2b.decode.l16", 2**31 + 11, 0.5, True, device="cpu", config=tiny,
                    chips_check=False, limits={"token_gap": 1e-4, "logit_gap": 1e-5})
    assert out["correct"] and not set(NEW) & set(out["metrics"])
