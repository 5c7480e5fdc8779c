"""Admission control: accumulate stream arrivals into fixed-shape batches.

A batch closes when it reaches `max_batch` queries OR when the next
arrival falls more than `max_wait` stream-seconds after the batch's first
arrival (the classic size-or-deadline rule). Batches then pad to the
plane's pow2 buckets, so the whole stream is served by a handful of
compiled widths — the same `_next_pow2` discipline the training pipeline
uses for participant rows.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.serve.stream import QueryStream


@dataclasses.dataclass(frozen=True)
class AdmittedBatch:
    ids: np.ndarray       # (n,) client ids, n <= max_batch
    arrivals: np.ndarray  # (n,) stream-seconds
    t_close: float        # stream time the batch was admitted


class AdmissionBatcher:
    """Greedy size-or-deadline batcher over a (time, id) arrival sequence."""

    def __init__(self, max_batch: int = 256, max_wait: float = 1e-3):
        assert max_batch >= 1
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)

    def admit(self, stream: QueryStream) -> List[AdmittedBatch]:
        out: List[AdmittedBatch] = []
        t, ids = stream.arrivals, stream.ids
        n = ids.size
        i = 0
        while i < n:
            j = min(i + self.max_batch, n)
            # deadline: everything admitted together arrived within
            # max_wait of the batch's first query
            cut = np.searchsorted(t, t[i] + self.max_wait, side="right")
            j = max(i + 1, min(j, int(cut)))
            out.append(
                AdmittedBatch(
                    ids=ids[i:j].copy(),
                    arrivals=t[i:j].copy(),
                    t_close=float(max(t[j - 1], t[i] + self.max_wait))
                    if j < n
                    else float(t[j - 1]),
                )
            )
            i = j
        return out
