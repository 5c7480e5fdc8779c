"""Table 3 / Figure 9: time-to-accuracy speedup + final-accuracy improvement
of Auxo over the cohort-agnostic FedYoGi baseline, per scenario dataset
(a port of ``benchmarks/table3_tta.py``)."""
from __future__ import annotations

from repro_torch.fl import run_auxo, run_fl
from repro_torch.paper.common import SCENARIOS, build, default_auxo, default_fl, emit, tta_speedup


def run(rounds: int = 100, scenarios=None, *, device=None):
    rows = []
    for name in scenarios or list(SCENARIOS):
        task, pop = build(name)
        fl = default_fl(rounds)
        base = run_fl(task, pop, fl, device=device)
        eng, hist = run_auxo(task, pop, fl, default_auxo(rounds), device=device)
        rows.append(
            dict(
                dataset=name,
                target_acc=max(h["acc_mean"] for h in base),
                speedup=tta_speedup(base, hist),
                base_final=base[-1]["acc_mean"],
                auxo_final=hist[-1]["acc_mean"],
                acc_improvement=hist[-1]["acc_mean"] - base[-1]["acc_mean"],
                n_cohorts=hist[-1]["n_cohorts"],
            )
        )
    emit(rows, "Table 3: time-to-accuracy")
    return rows


if __name__ == "__main__":
    run()
