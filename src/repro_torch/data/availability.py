"""Client availability and device-speed traces.

Synthetic generators matching the statistics of the FedScale traces the
paper uses: ~5% of the population available in any window (diurnal cycle +
per-client phase), heavy-tailed device speeds (lognormal), and the
over-commitment straggler policy of production FL [10]: select 1.25×P,
keep the fastest P.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class AvailabilityTrace:
    n_clients: int
    base_rate: float = 0.05  # expected availability fraction
    diurnal_amp: float = 0.6  # relative amplitude of the day cycle
    period: float = 144.0  # rounds per simulated "day"
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.phase = rng.uniform(0, 2 * np.pi, self.n_clients)
        # per-client propensity (some clients are almost never online)
        self.propensity = rng.lognormal(0.0, 0.8, self.n_clients)
        self.propensity /= self.propensity.mean()

    def round_rng(self, round_idx: int) -> np.random.Generator:
        """Seeded per-round substream: the round's draws depend only on
        (trace seed, round index), never on how many draws other rounds —
        or other components sharing a generator — consumed before."""
        return np.random.default_rng((self.seed, 0xA7A11, round_idx))

    def available(
        self, round_idx: int, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """Returns the client ids available for this round.

        Pass an explicit generator to draw from a shared stream (the
        engine's legacy behavior); omit it for the reproducible per-round
        substream (``round_rng``).
        """
        if rng is None:
            rng = self.round_rng(round_idx)
        t = 2 * np.pi * round_idx / self.period
        rate = self.base_rate * (1 + self.diurnal_amp * np.sin(t + self.phase))
        rate = np.clip(rate * self.propensity, 0.0, 1.0)
        return np.nonzero(rng.random(self.n_clients) < rate)[0]


@dataclasses.dataclass
class DeviceSpeeds:
    """Per-client compute latency multipliers (system heterogeneity)."""

    n_clients: int
    sigma: float = 0.6  # lognormal spread; 0 = homogeneous
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 17)
        self.speed = rng.lognormal(0.0, self.sigma, self.n_clients)

    def round_duration(
        self,
        participants: Sequence[int],
        samples,
        overcommit: float = 1.25,
    ):
        """Simulated round wall-clock with over-commitment straggler drop.

        Returns (kept participant ids, duration). The slowest
        (overcommit-1)/overcommit fraction are dropped (their updates are
        discarded, as in [10]), so duration = slowest *kept* participant.
        ``samples`` may be a per-participant sequence or one scalar; the
        whole computation is vectorized (no per-participant python loop).
        """
        part = np.asarray(participants, np.int64)
        lat = self.speed[part] * np.maximum(np.asarray(samples, np.float64), 1.0)
        keep_n = max(1, int(round(part.size / overcommit)))
        kept_idx = np.argsort(lat)[:keep_n]
        duration = float(lat[kept_idx].max()) if keep_n else 0.0
        return part[kept_idx], duration
