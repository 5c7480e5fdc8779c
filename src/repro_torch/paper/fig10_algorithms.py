"""Figure 10: Auxo composes with (and speeds up) different FL algorithms:
FedYoGi, FedAvg, FedProx, q-FedAvg — plus FTFA personalization on top (a
port of ``benchmarks/fig10_algorithms.py``)."""
from __future__ import annotations

from repro_torch.fl import run_auxo, run_fl
from repro_torch.paper.common import build, default_auxo, default_fl, emit, tta_speedup

ALGOS = [
    ("fedyogi", {}),
    ("fedavg", {"server_lr": 1.0}),
    ("fedprox", {"prox_mu": 0.05, "server_lr": 1.0}),
    ("qfedavg", {"qfed_q": 1.0, "server_lr": 1.0}),
]


def run(rounds: int = 100, *, device=None):
    task, pop = build("openimage-like")
    rows = []
    for algo, kw in ALGOS:
        fl = default_fl(rounds, algorithm=algo, **kw)
        base = run_fl(task, pop, fl, device=device)
        eng, hist = run_auxo(task, pop, fl, default_auxo(rounds), device=device)
        row = dict(
            algorithm=algo,
            speedup=tta_speedup(base, hist),
            base_final=base[-1]["acc_mean"],
            auxo_final=hist[-1]["acc_mean"],
        )
        if algo == "fedyogi":
            # FTFA personalization on top of cohort models (paper §7.2)
            row["ftfa_auxo"] = eng.ftfa_eval(steps=5)
        rows.append(row)
    emit(rows, "Figure 10: FL algorithms")
    return rows


if __name__ == "__main__":
    run()
