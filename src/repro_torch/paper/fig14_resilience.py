"""Figure 14: resilience — local DP noise, corrupted (label-flipping)
clients, and unstable clients losing affinity records (a port of
``benchmarks/fig14_resilience.py``)."""
from __future__ import annotations

from repro_torch.fl import run_auxo, run_fl
from repro_torch.paper.common import build, default_auxo, default_fl, emit

# the sweeps: local DP's sigma (~ eps = 8, 4, 2), the label-poisoned share
# (<= 15% like the paper) and the affinity-record loss rate
LDP_SIGMAS = (0.0, 0.6, 0.77, 1.0)
CORRUPT_FRACS = (0.0, 0.05, 0.10, 0.15)
AFFINITY_LOSS_RATES = (0.0, 0.05, 0.1, 0.2)


def run(rounds: int = 80, *, device=None):
    rows = []
    task, pop = build("openimage-like")

    def both(fl):
        base = run_fl(task, pop, fl, device=device)
        _, hist = run_auxo(task, pop, fl, default_auxo(rounds), device=device)
        return base, hist

    # (a) local differential privacy (sigma sweep ~ eps = 8, 4, 2)
    for sigma in LDP_SIGMAS:
        base, hist = both(default_fl(rounds, dp_clip=1.0 if sigma else 0.0, dp_sigma=sigma))
        rows.append(dict(sweep="ldp_sigma", value=sigma,
                         base_final=base[-1]["acc_mean"],
                         auxo_final=hist[-1]["acc_mean"]))
    # (b) corrupted clients (label poisoning, <=15% like the paper)
    for frac in CORRUPT_FRACS:
        base, hist = both(default_fl(rounds, corrupt_frac=frac))
        rows.append(dict(sweep="corrupt_frac", value=frac,
                         base_final=base[-1]["acc_mean"],
                         auxo_final=hist[-1]["acc_mean"]))
    # (c) unstable clients (affinity record loss)
    for rate in AFFINITY_LOSS_RATES:
        base, hist = both(default_fl(rounds, affinity_loss_rate=rate))
        rows.append(dict(sweep="affinity_loss", value=rate,
                         base_final=base[-1]["acc_mean"],
                         auxo_final=hist[-1]["acc_mean"]))
    emit(rows, "Figure 14: resilience")
    return rows


if __name__ == "__main__":
    run()
