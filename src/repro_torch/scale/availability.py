"""Streaming availability: per-chunk Poisson thinning instead of an O(N) draw.

``AvailabilityTrace`` draws one Bernoulli per client per round — fine at
thousands of clients, fatal at millions (the draw alone is O(N) host work
and its phase/propensity tables are O(N) memory). ``StreamingAvailability``
makes the round's available set a *sampled* quantity:

- the population is split into fixed chunks of ``chunk_clients`` ids;
- per round, each chunk draws its available COUNT from a Poisson whose
  rate carries the diurnal cycle through a deterministic per-chunk phase
  (a hash of the chunk index — chunks behave like timezone blocks);
- participant ids are then sampled *within* chunks proportionally to the
  counts, and only as many as the caller's candidate budget — the full
  active set is never materialized (``sample``), or materialized at
  O(active) if a caller really wants it (``available``).

Per-round cost is O(n_chunks + budget); memory is O(1). The draws use a
seeded per-(round, chunk) substream when no generator is passed, so any
round's availability is reproducible independent of call order.

Fidelity contract: ``mode="compat"`` IS the dense trace (it inherits
``AvailabilityTrace``'s exact per-client draw — bit-for-bit identical
streams, used by the small-N equivalence tests). ``mode="chunked"`` keeps
the population-level statistics (base rate, diurnal swing) but trades two
per-client details for the O(active) cost model: per-client propensity
heterogeneity collapses to the chunk level, and id collisions inside a
chunk dedupe (a ~rate/2 relative undercount).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.data.availability import AvailabilityTrace

_HASH_MULT = 2654435761  # Knuth multiplicative hash, mod 2^32


@dataclasses.dataclass
class StreamingAvailability(AvailabilityTrace):
    """Drop-in ``AvailabilityTrace`` with an O(active)-per-round mode.

    mode="compat"  — exact dense semantics (small N, bit-equal runs);
    mode="chunked" — per-chunk Poisson counts + in-chunk id sampling.
    """

    mode: str = "compat"
    chunk_clients: int = 1 << 14

    def __post_init__(self):
        assert self.mode in ("compat", "chunked"), self.mode
        if self.mode == "compat":
            super().__post_init__()

    # ------------------------------------------------------------- chunked
    @property
    def n_chunks(self) -> int:
        return -(-self.n_clients // self.chunk_clients)

    def _chunk_sizes(self) -> np.ndarray:
        sizes = np.full(self.n_chunks, self.chunk_clients, np.int64)
        sizes[-1] = self.n_clients - (self.n_chunks - 1) * self.chunk_clients
        return sizes

    def _chunk_rates(self, round_idx: int) -> np.ndarray:
        """Per-chunk availability rate at this round's point in the day
        cycle; the chunk phase is a pure hash (no per-chunk state)."""
        h = (
            np.arange(self.n_chunks, dtype=np.uint64) * _HASH_MULT
            + np.uint64(self.seed * 40503 + 11)
        ) % np.uint64(1 << 32)
        phase = 2 * np.pi * (h.astype(np.float64) / float(1 << 32))
        t = 2 * np.pi * round_idx / self.period
        rate = self.base_rate * (1 + self.diurnal_amp * np.sin(t + phase))
        return np.clip(rate, 0.0, 1.0)

    def sample(
        self,
        round_idx: int,
        k: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, int]:
        """Draw up to ``k`` available client ids (all of them if None).

        Returns (sorted unique ids, total available count). O(n_chunks +
        k) in chunked mode: per-chunk Poisson counts, a multinomial split
        of the budget over chunks, then uniform in-chunk rows.
        """
        if self.mode == "compat":
            ids = AvailabilityTrace.available(self, round_idx, rng)
            n = ids.size
            if k is not None and ids.size > k:
                if rng is None:
                    # distinct substream: round_rng(round_idx) was already
                    # consumed by the Bernoulli draw above — replaying it
                    # would correlate the subset with the thresholds
                    rng = np.random.default_rng(
                        (self.seed, 0xA7A11, round_idx, 1)
                    )
                sub = rng.choice(ids.size, size=k, replace=False)
                ids = np.sort(ids[sub])
            return ids, n
        if rng is None:
            rng = self.round_rng(round_idx)
        sizes = self._chunk_sizes()
        lam = self._chunk_rates(round_idx) * sizes
        counts = np.minimum(rng.poisson(lam), sizes)
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64), 0
        kk = total if k is None else min(int(k), total)
        pick = rng.choice(counts.size, size=kk, p=counts / total)
        rows = rng.integers(0, sizes[pick])
        ids = np.unique(pick.astype(np.int64) * self.chunk_clients + rows)
        return ids, total

    def available(
        self, round_idx: int, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        if self.mode == "compat":
            return AvailabilityTrace.available(self, round_idx, rng)
        return self.sample(round_idx, None, rng)[0]
