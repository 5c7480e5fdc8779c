"""Reward computation and ε-greedy cohort selection (paper §4.3).

Port of ``repro.core.selection``. Instant reward for participant i of
cohort m:
    D_i = ||g_i − ḡ_m||₂,  thr = avg(D) + std(D),  ΔR_i = 1 − D_i / thr
Reward record update (EMA, γ = 0.2): R ← γ·ΔR + (1−γ)·R.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


def instant_reward_batched(sketches: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ΔR for every participant of C cohorts at once.

    sketches: (C, P, d), mask: (C, P) validity weights (padded rows get
    weight 0 in the center/threshold statistics but still receive a ΔR).
    Returns (delta (C, P), distances (C, P)).
    """
    x = sketches.float()
    m = mask.float()
    tot = torch.clamp(m.sum(-1, keepdim=True), min=1.0)  # (C, 1)
    center = (x * m[..., None]).sum(-2, keepdim=True) / tot[..., None]
    d = torch.linalg.vector_norm(x - center, dim=-1)
    mean_d = (d * m).sum(-1, keepdim=True) / tot
    var_d = (m * (d - mean_d) ** 2).sum(-1, keepdim=True) / tot
    thr = mean_d + torch.sqrt(torch.clamp(var_d, min=0.0))
    delta = 1.0 - d / torch.clamp(thr, min=1e-9)
    return delta, d


def instant_reward_np(sketches: np.ndarray, mask=None) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of ``instant_reward`` for the HOST control plane (§⑤):
    stage ③ of the overlapped round pipeline avoids kernel launches, which
    would queue behind the in-flight fused step. Verbatim copy of the JAX
    package's twin."""
    x = np.asarray(sketches, np.float32)
    m = (
        np.ones((x.shape[0],), np.float32)
        if mask is None
        else np.asarray(mask, np.float32)
    )
    tot = max(float(m.sum()), 1.0)
    center = (x * m[:, None]).sum(0, keepdims=True) / tot
    d = np.linalg.norm(x - center, axis=1)
    mean_d = float((d * m).sum()) / tot
    var_d = float((m * (d - mean_d) ** 2).sum()) / tot
    thr = mean_d + np.sqrt(max(var_d, 0.0))
    delta = 1.0 - d / max(thr, 1e-9)
    return delta.astype(np.float32), d


def instant_reward(sketches: torch.Tensor, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cohort: (P, d) -> (delta (P,), distances (P,))."""
    m = torch.ones(sketches.shape[0], device=sketches.device) if mask is None else mask
    delta, d = instant_reward_batched(sketches[None], m[None])
    return delta[0], d[0]


def update_rewards(prev: float, delta: float, gamma: float = 0.2) -> float:
    return gamma * delta + (1.0 - gamma) * prev


@dataclasses.dataclass
class CohortSelector:
    """Decaying ε-greedy over the client's affinity records."""

    epsilon0: float = 0.8
    decay: float = 0.98
    min_epsilon: float = 0.05

    def epsilon(self, round_idx: int) -> float:
        """Exploration probability of round ``round_idx`` (matching draws
        the explore/exploit coin per client in fl/pipeline.py)."""
        return max(self.min_epsilon, self.epsilon0 * (self.decay**round_idx))

    def select(
        self,
        rng: np.random.Generator,
        rewards: Dict[str, float],
        leaves: List[str],
        round_idx: int,
    ) -> str:
        """Pick a cohort *request* for one client (verbatim copy of the JAX
        package's host code: one ``rng.random()``, then ``rng.integers`` on
        exploration).

        The request may name a stale (non-leaf) cohort — e.g. the parent a
        client trained with before a partition it hasn't heard about. The
        coordinator resolves such requests to a leaf using the client's
        cluster index (§5.1 Request Match), so exploitation runs over
        everything the client knows.
        """
        if not leaves:
            raise ValueError("no leaf cohorts")
        eps = self.epsilon(round_idx)
        if not rewards or rng.random() < eps:
            return leaves[rng.integers(len(leaves))]
        return max(rewards.items(), key=lambda kv: kv[1])[0]
