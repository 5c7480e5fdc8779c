"""Partition criteria (paper §4.4, Lemma 4.1).

A cohort is partitioned into (up to) K children when ALL of:

1. Discernible clusters (Alg. 1 line 20): the EMA separation margin —
   mean(cos to own prototype) − mean(cos to best other prototype) — exceeds
   `margin_threshold`, AND the weighted child dispersion satisfies the
   Lemma-4.1 √K reduction (with slack): heterogeneity must drop enough to
   compensate the proportional resource split.
2. Resource floor: expected post-partition participants per child
   ≥ max(min_members, α·sqrt(P₀ / J₀²)).
3. Timing window: not before `start_frac` nor after `end_frac` of the
   training budget (partitioning too early hurts generalizability, too
   late wastes the heterogeneity win — §7.4).
4. Cluster balance: no candidate child would receive < `min_members`.

Copy of ``repro.core.criteria`` (pure Python; the port never imports the
JAX package).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class PartitionCriteria:
    k: int = 2  # children per split
    alpha: float = 1.0  # Lemma 4.1 constant (workload-dependent)
    min_members: int = 20  # minimum meaningful cohort size (§3.1)
    start_frac: float = 0.1
    end_frac: float = 0.85
    margin_threshold: float = 0.4  # separation needed to call clusters "real"
    het_reduction_slack: float = 2.0  # multiply the 1/sqrt(K) target

    def resource_floor(self, p0: float, j0: float) -> float:
        """Lemma 4.1: P ≥ α · sqrt(P₀ / J₀²)."""
        j0 = max(j0, 1e-6)
        return self.alpha * math.sqrt(p0 / (j0 * j0))

    def should_partition(
        self,
        *,
        round_idx: int,
        total_rounds: int,
        parent_dispersion: float,
        child_dispersions: Sequence[float],
        child_sizes: Sequence[float],
        participants_per_round: float,
        initial_participants: float,
        initial_heterogeneity: float,
        clustering_rounds: int,
        margin: float = 0.0,
        min_clustering_rounds: int = 5,
    ) -> bool:
        if len(child_dispersions) < 2:
            return False
        frac = round_idx / max(total_rounds, 1)
        if frac < self.start_frac or frac > self.end_frac:
            return False
        if clustering_rounds < min_clustering_rounds:
            return False  # prototypes not yet stable
        k = len(child_dispersions)
        total = sum(child_sizes)
        if total <= 0 or min(child_sizes) < self.min_members:
            return False
        # (1a) discernible clusters: separation margin
        if margin < self.margin_threshold:
            return False
        # (1b) heterogeneity reduction ≥ sqrt(K) (with slack)
        mean_child = sum(d * s for d, s in zip(child_dispersions, child_sizes)) / total
        target = parent_dispersion / math.sqrt(k) * self.het_reduction_slack
        if mean_child > target:
            return False
        # (2) Lemma 4.1 resource floor on the post-partition share
        post_share = participants_per_round / k
        floor = self.resource_floor(initial_participants, initial_heterogeneity)
        if post_share < max(float(self.min_members) / 4.0, floor):
            return False
        return True
