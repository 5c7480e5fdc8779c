"""Figures 12-13: sensitivity — heterogeneity degree (affine shift),
partition time, number of cohorts, clustering start time (a port of
``benchmarks/fig13_sensitivity.py``)."""
from __future__ import annotations

from repro_torch.data import make_population
from repro_torch.fl import run_auxo, run_fl
from repro_torch.fl.task import MLPTask
from repro_torch.paper.common import build, default_auxo, default_fl, emit, tta_speedup

# the sweeps: the population's affine shift, the partition window's start
# (it ends 0.5 later, at most 0.9), the cohort cap and the clustering start
AFFINE_SHIFTS = (0.0, 0.5, 1.0, 2.0)
PARTITION_STARTS = (0.02, 0.1, 0.3, 0.6)
MAX_COHORTS = (1, 2, 4, 8)
CLUSTER_STARTS = (0.01, 0.05, 0.15, 0.3)


def run(rounds: int = 80, *, device=None):
    rows = []
    # (a) heterogeneity degree via affine shift [61]
    for shift in AFFINE_SHIFTS:
        pop = make_population(n_clients=800, n_groups=4, group_sep=0.0,
                              dirichlet=2.0, label_conflict=0.5,
                              affine_shift=shift, seed=1)
        task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
        fl = default_fl(rounds)
        base = run_fl(task, pop, fl, device=device)
        _, hist = run_auxo(task, pop, fl, default_auxo(rounds), device=device)
        rows.append(dict(sweep="affine_shift", value=shift,
                         base_final=base[-1]["acc_mean"],
                         auxo_final=hist[-1]["acc_mean"],
                         auxo_worst10=hist[-1]["acc_worst10"],
                         speedup=tta_speedup(base, hist)))
    task, pop = build("openimage-like")
    fl = default_fl(rounds)

    def auxo_row(sweep, value, **kw):
        _, hist = run_auxo(task, pop, fl, default_auxo(rounds, **kw), device=device)
        rows.append(dict(sweep=sweep, value=value,
                         base_final=float("nan"),
                         auxo_final=hist[-1]["acc_mean"],
                         auxo_worst10=hist[-1]["acc_worst10"], speedup=0.0))

    # (b) partition time window
    for start in PARTITION_STARTS:
        auxo_row("partition_start", start, partition_start_frac=start,
                 partition_end_frac=min(0.9, start + 0.5))
    # (c) number of cohorts
    for mc in MAX_COHORTS:
        auxo_row("max_cohorts", mc, max_cohorts=mc)
    # (d) clustering start time
    for cs in CLUSTER_STARTS:
        auxo_row("cluster_start", cs, clustering_start_frac=cs)
    emit(rows, "Figure 13: sensitivity")
    return rows


if __name__ == "__main__":
    run()
