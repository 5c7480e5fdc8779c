"""Synthetic production query stream for the serving plane.

Poisson arrivals over a configurable hot/cold client-identity mix: "hot"
queries come from clients the training plane has fingerprinted (store /
affinity lookup at serve time), "cold" ones from clients that must take
the probe path. Arrival times are in abstract stream seconds — the
admission batcher uses them only to decide batch boundaries; benchmarks
replay the admitted batches as fast as the device allows (burst drain).

Everything is seeded and deterministic, so two engines serving the same
stream can be compared bit-for-bit (the §⑧ flush-rule test).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    n_queries: int = 10_000
    rate: float = 50_000.0  # mean arrivals per stream-second
    hot_frac: float = 0.9   # fraction of queries drawn from the hot pool
    seed: int = 0


class QueryStream:
    """Seeded Poisson query stream over explicit hot/cold id pools.

    `hot_ids` should be clients with a training fingerprint, `cold_ids`
    clients without one; the stream itself only samples ids — the plane
    decides hot/cold by looking at `fp_seen`, so a client that *becomes*
    hot mid-run is simply served via the cheaper path from then on.
    """

    def __init__(self, cfg: StreamConfig, hot_ids, cold_ids):
        self.cfg = cfg
        hot = np.asarray(hot_ids, np.int64)
        cold = np.asarray(cold_ids, np.int64)
        assert hot.size or cold.size, "stream needs a non-empty id pool"
        rng = np.random.default_rng(cfg.seed)
        n = cfg.n_queries
        # exponential inter-arrival gaps -> Poisson process arrival times
        self.arrivals = np.cumsum(rng.exponential(1.0 / cfg.rate, size=n))
        take_hot = rng.random(n) < (cfg.hot_frac if hot.size else 0.0)
        if not cold.size:
            take_hot[:] = True
        ids = np.empty(n, np.int64)
        nh = int(take_hot.sum())
        ids[take_hot] = hot[rng.integers(0, hot.size, size=nh)] if nh else 0
        ids[~take_hot] = (
            cold[rng.integers(0, cold.size, size=n - nh)] if n - nh else 0
        )
        self.ids = ids

    def __len__(self) -> int:
        return self.cfg.n_queries

    def __iter__(self) -> Iterator[Tuple[float, int]]:
        return zip(self.arrivals.tolist(), self.ids.tolist())
