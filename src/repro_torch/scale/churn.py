"""Client churn: arrivals and departures as a per-round event stream.

The paper's deployment model (§2, §5.2) assumes a population that is never
static: devices enroll, drop out, and re-appear with their soft state gone.
``ChurnStream`` generates that dynamics at O(churned clients) per round —
it never touches the full population:

- departures: a Poisson draw over the alive population picks ids that
  leave; the engine wipes ALL their server-held soft state
  (``PopulationStore.depart``) — affinity records, fingerprint EMA, probe
  cache — so a departure is indistinguishable from the §5.2
  soft-state-loss failure mode;
- arrivals: each departed client independently returns with probability
  ``return_rate`` per round. A re-arrival is a COLD START: it holds no
  fingerprint, so evaluation-time serving routes it through the
  probe-fingerprint path (one local probe round against the root model),
  exactly like a never-trained client. With ``FLConfig.warm_rearrivals``
  the first check-in is additionally seeded into the probe fingerprint's
  nearest-identity leaf instead of re-exploring at random.

Re-arrivals need no data-side restore either: the §⑦ DataPlane serves any
client by ID (`AuxoEngine.apply_churn` just invalidates the plane's
caches) — with a ProceduralDataPlane the returning client's shard
regenerates from its hash-seeded stream, byte-identical, with no table of
per-client arrays anywhere.

Events draw from a per-round seeded substream, so a given round's churn is
a function of (seed, round history) only.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class ChurnStream:
    """Arrival/departure events over a population of ``n_clients`` ids.

    ``depart_rate`` is the per-round departure probability of an alive
    client (expected departures = rate × alive); ``return_rate`` the
    per-round return probability of a departed one. The stream tracks only
    the departed pool — cost and memory are O(churned), not O(N).
    """

    n_clients: int
    depart_rate: float = 0.01
    return_rate: float = 0.1
    seed: int = 0

    def __post_init__(self):
        self._away = np.zeros(0, np.int64)  # currently-departed pool

    @property
    def away(self) -> np.ndarray:
        return self._away

    def step(self, round_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """One round of churn → (departures, arrivals), disjoint id sets."""
        rng = np.random.default_rng((self.seed, 0xC4C4, round_idx))
        back = rng.random(self._away.size) < self.return_rate
        arrivals = self._away[back]
        self._away = self._away[~back]
        alive = self.n_clients - self._away.size
        k = int(rng.poisson(self.depart_rate * max(alive, 0)))
        departures = np.zeros(0, np.int64)
        if k > 0:
            cand = rng.integers(0, self.n_clients, size=k)
            departures = np.setdiff1d(  # unique, minus away pool + returnees
                cand, np.concatenate([self._away, arrivals])
            )
            self._away = np.concatenate([self._away, departures])
        return departures, arrivals
