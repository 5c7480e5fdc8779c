"""Shared scaffolding of the paper's drivers: scenario populations and the
time-to-accuracy math (a port of ``benchmarks/common.py``).

The container is offline, so the paper's datasets are represented by
synthetic populations whose *heterogeneity structure* matches each dataset
class: e.g. "openimage-like" = many latent cohorts with feature+label
skew; "reddit-like" = near-homogeneous (the paper's no-partition case);
"femnist-like" = few strong cohorts.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.data import make_population
from repro_torch.fl import AuxoConfig, FLConfig
from repro_torch.fl.task import MLPTask

SCENARIOS: Dict[str, dict] = {
    # name -> population kwargs (heterogeneity structure stand-ins)
    "femnist-like": dict(n_clients=800, n_groups=2, group_sep=0.0, dirichlet=2.0, label_conflict=0.5),
    "openimage-like": dict(n_clients=1000, n_groups=4, group_sep=0.0, dirichlet=2.0, label_conflict=0.6),
    "speech-like": dict(n_clients=600, n_groups=2, group_sep=1.5, dirichlet=1.0, label_conflict=0.4),
    "amazon-like": dict(n_clients=1200, n_groups=4, group_sep=0.0, dirichlet=2.0, label_conflict=0.7),
    "reddit-like": dict(n_clients=800, n_groups=1, group_sep=0.0, dirichlet=3.0, label_conflict=0.0),
}


def build(name: str, seed: int = 1):
    pop = make_population(seed=seed, **SCENARIOS[name])
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    return task, pop


def default_fl(rounds: int = 100, seed: int = 1, **kw) -> FLConfig:
    base = dict(
        rounds=rounds,
        participants_per_round=100,
        eval_every=max(2, rounds // 20),
        use_availability=True,
        seed=seed,
    )
    base.update(kw)
    return FLConfig(**base)


def default_auxo(rounds: int = 100, **kw) -> AuxoConfig:
    base = dict(
        d_sketch=128,
        cluster_k=2,
        max_cohorts=4,
        clustering_start_frac=0.03,
        partition_start_frac=0.08,
        partition_end_frac=0.7,
        min_members=10,
        margin_threshold=0.5,
    )
    base.update(kw)
    return AuxoConfig(**base)


def time_to_accuracy(history: List[dict], target: float) -> Optional[float]:
    """Simulated wall-clock at which acc_mean first reaches target."""
    for h in history:
        if h["acc_mean"] >= target:
            return h["time"]
    return None


def tta_speedup(base_hist: List[dict], auxo_hist: List[dict]) -> float:
    """Paper Table 3: target = highest accuracy attainable by the baseline."""
    target = max(h["acc_mean"] for h in base_hist)
    tb = time_to_accuracy(base_hist, target)
    ta = time_to_accuracy(auxo_hist, target)
    if ta is None:
        return 0.0  # did not reach
    if tb is None:
        return float("inf")
    return tb / max(ta, 1e-9)


def emit(rows: List[dict], name: str):
    print(f"\n== {name} ==")
    if not rows:
        return
    cols: List[str] = []
    for r in rows:
        for c in r:
            if c not in cols:
                cols.append(c)
    print(",".join(cols))
    for r in rows:
        vals = (r.get(c, "") for c in cols)
        print(",".join(str(round(v, 4)) if isinstance(v, float) else str(v) for v in vals))
