"""Table 4: model bias — worst/best 10% client accuracy and variance (a
port of ``benchmarks/table4_bias.py``)."""
from __future__ import annotations

from repro_torch.fl import run_auxo, run_fl
from repro_torch.paper.common import build, default_auxo, default_fl, emit


def run(rounds: int = 100, scenarios=None, *, device=None):
    rows = []
    for name in scenarios or ["openimage-like", "femnist-like", "speech-like", "amazon-like"]:
        task, pop = build(name)
        fl = default_fl(rounds)
        base = run_fl(task, pop, fl, device=device)
        _, hist = run_auxo(task, pop, fl, default_auxo(rounds), device=device)
        for setting, h in (("auxo", hist[-1]), ("baseline", base[-1])):
            rows.append(
                dict(
                    dataset=name,
                    setting=setting,
                    worst10=h["acc_worst10"],
                    best10=h["acc_best10"],
                    variance=h["acc_var"],
                )
            )
    emit(rows, "Table 4: model bias")
    return rows


if __name__ == "__main__":
    run()
