"""Spans of the port's own layers on the host's clock, off by default.

``span(name, **meta)`` marks a stretch of host code: a round, a client's
forward pass, one block's draw of the sketch, one fleet step of the decoder.
``recording()`` turns spans on for its body and yields the list that the
finished spans are appended to; it is whole when the body ends.

With recording off, ``span`` returns one shared no-op object: no span is
made, nothing is kept, no CUDA event is recorded and the device is never
synchronised. With recording on a span keeps only host times
(``time.perf_counter_ns``): where the device spent its time is read from a
profiler's trace of the same steps, by joining each operation's launch to
the span open on the host when it was issued. Meta that costs anything to
build is built by the caller only when ``on()`` is true.

Each thread keeps its own stack of open spans, so a span opened inside
another on the same thread is its child; a span with nothing open around it
is a root (a federated round, a decode call).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, List, Optional

now = time.perf_counter_ns  # the spans' clock, in nanoseconds

_kept: Optional[List["Span"]] = None  # the finished spans while recording
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One finished (or open) span: ``name``; ``id``; ``root``, the id of
    the outermost span open around it on its thread (its own id for a
    root); ``parent``, the id of the span open directly around it (None
    for a root); ``start`` and ``end`` in ``now()`` nanoseconds; ``meta``."""

    __slots__ = ("name", "id", "root", "parent", "start", "end", "meta", "_kept")

    def __init__(self, name: str, meta: dict, kept: List["Span"]):
        self.name, self.meta, self._kept = name, meta, kept
        self.id = next(_ids)
        self.start = self.end = 0

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.start = now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = now()
        _stack().pop()
        self._kept.append(self)
        return False


class _Off:
    """The span handed out while nothing records: enters and exits, keeps nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def on() -> bool:
    """Whether spans are being recorded (build costly meta only then)."""
    return _kept is not None


def span(name: str, **meta):
    """A context manager around one stretch of the program: a ``Span`` kept
    by the open ``recording()``, else the shared ``OFF``."""
    kept = _kept
    if kept is None:
        return OFF
    return Span(name, meta, kept)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record every span that finishes in the body; yields the list they
    are appended to, in the order they close. Recordings do not nest."""
    global _kept
    if _kept is not None:
        raise RuntimeError("a recording is already open")
    kept: List[Span] = []
    _kept = kept
    try:
        yield kept
    finally:
        _kept = None
