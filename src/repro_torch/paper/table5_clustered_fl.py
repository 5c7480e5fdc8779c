"""Table 5 / Figure 11: Auxo vs clustered-FL baselines (IFCA, FL+HC,
FlexCFL; CFL small-scale) on time / resource / final accuracy, all measured
against the no-cohort baseline. Availability traces are disabled to match
the baselines' constraints (paper §7.3). Includes the paper-faithful Auxo
(assisted_matching=False) next to the full system as an ablation (a port
of ``benchmarks/table5_clustered_fl.py``)."""
from __future__ import annotations

from repro_torch.data import make_population
from repro_torch.fl import run_auxo, run_fl
from repro_torch.fl.baselines import CFL, FLHC, IFCA, FlexCFL
from repro_torch.fl.task import MLPTask
from repro_torch.paper.common import build, default_auxo, default_fl, emit, time_to_accuracy

DATASETS = ("femnist-like", "amazon-like")


def _metrics(base, hist, res_base, res):
    target = max(h["acc_mean"] for h in base)
    tb = time_to_accuracy(base, target)
    ta = time_to_accuracy(hist, target)
    speedup = (tb / ta) if (ta and tb) else 0.0
    eff = (res_base / res) if (ta and res) else 0.0
    return speedup, eff, hist[-1]["acc_mean"] - base[-1]["acc_mean"]


def run(rounds: int = 80, *, device=None):
    rows = []
    for name in DATASETS:
        task, pop = build(name)
        fl = default_fl(rounds, use_availability=False)
        base = run_fl(task, pop, fl, device=device)
        res_base = base[-1]["resource"]

        def _res_at_target(hist):
            target = max(h["acc_mean"] for h in base)
            for h in hist:
                if h["acc_mean"] >= target:
                    return h["resource"]
            return None

        entries = {}
        _, auxo_hist = run_auxo(task, pop, fl, default_auxo(rounds), device=device)
        entries["auxo"] = auxo_hist
        _, faithful = run_auxo(task, pop, fl, default_auxo(rounds, assisted_matching=False), device=device)
        entries["auxo-paper-faithful"] = faithful
        entries["ifca"] = IFCA(task, pop, fl, k=4, device=device).run()
        entries["fl+hc"] = FLHC(task, pop, fl, k=4, warmup_rounds=max(4, rounds // 8), device=device).run()
        entries["flexcfl"] = FlexCFL(task, pop, fl, k=4, device=device).run()

        for algo, hist in entries.items():
            sp, _, dacc = _metrics(base, hist, res_base, hist[-1]["resource"])
            res_t = _res_at_target(hist)
            res_b_t = _res_at_target(base)
            eff = (res_b_t / res_t) if (res_t and res_b_t) else 0.0
            rows.append(
                dict(dataset=name, algo=algo, speedup=sp, resource_eff=eff,
                     final_acc_gain=dacc)
            )
    # CFL small-scale (full participation requirement)
    small_fl = default_fl(20, use_availability=False, participants_per_round=60)
    small_pop = make_population(n_clients=100, n_groups=2, group_sep=0.0,
                                label_conflict=0.5, seed=2)
    small_task = MLPTask(dim=small_pop.dim, n_classes=small_pop.n_classes)
    cfl_hist = CFL(small_task, small_pop, small_fl, k=2, device=device).run()
    rows.append(dict(dataset="femnist-small", algo="cfl",
                     speedup=0.0, resource_eff=0.0,
                     final_acc_gain=cfl_hist[-1]["acc_mean"]))
    emit(rows, "Table 5: clustered-FL comparison")
    return rows


if __name__ == "__main__":
    run()
