"""Spans timed on the device's stream with CUDA events, recorded from the
benchmark's own files around the calls into the program's layers.

An event is recorded where the host reaches it and timestamped where the
stream reaches it, so a span between two events is device time, waits for
the host included. Events are resolved once the window has closed (one
synchronisation). On a CPU tensor's device (the tests) the host clock
stands in for the events.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch


class _HostEvent:
    def __init__(self):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """Named lists of (start, end, meta) events, resolved to (ms, meta)."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.open: Dict[str, List[Tuple[object, object, object]]] = {}
        self.marks: Dict[str, List[Tuple[object, object]]] = {}

    def event(self):
        ev = torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()
        ev.record()
        return ev

    def add(self, name: str, start, end, meta=None):
        self.open.setdefault(name, []).append((start, end, meta))

    def mark(self, name: str, meta=None):
        """A point on the stream; consecutive marks of a name give gaps."""
        self.marks.setdefault(name, []).append((self.event(), meta))

    def resolve(self) -> Dict[str, list]:
        """{name: [(ms, meta), ...]} for spans, and for marks the gaps
        between consecutive marks, each with the earlier mark's meta."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {name: [(a.elapsed_time(b), m) for a, b, m in evs] for name, evs in self.open.items()}
        for name, evs in self.marks.items():
            out[name] = [(a.elapsed_time(b), m) for (a, m), (b, _) in zip(evs, evs[1:])]
        return out
