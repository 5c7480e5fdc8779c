"""Quickstart on the card: Auxo cohort discovery on a conflicting-concept
population (the PyTorch port's ``examples/quickstart.py``).

Four latent client groups share features but hold conflicting label
concepts; a single global model caps out, Auxo discovers the cohorts from
gradient sketches and trains one model per cohort. Runs on the card unless
``--device cpu`` is given; ``--rounds`` and ``--clients`` shorten the run.

  PYTHONPATH=src python examples/port_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.data import make_population
from repro_torch.fl import AuxoConfig, FLConfig, MLPTask, run_auxo, run_fl


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=600)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    pop = make_population(
        n_clients=args.clients,
        n_groups=2,
        group_sep=0.0,
        dirichlet=2.0,
        label_conflict=0.6,
        seed=0,
    )
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    fl = FLConfig(rounds=args.rounds, participants_per_round=80, eval_every=10, seed=0,
                  use_availability=False)

    print("== cohort-agnostic FedYoGi baseline ==")
    base = run_fl(task, pop, fl, device=dev)
    for h in base:
        print(f"  round {h['round']:3d}  acc {h['acc_mean']:.3f}  (1 global model)")

    print("== Auxo ==")
    eng, hist = run_auxo(
        task, pop, fl,
        AuxoConfig(d_sketch=64, cluster_k=2, max_cohorts=2,
                   clustering_start_frac=0.05, partition_start_frac=0.1,
                   min_members=8),
        device=dev,
    )
    for h in hist:
        print(f"  round {h['round']:3d}  acc {h['acc_mean']:.3f}  cohorts={h['n_cohorts']}")

    groups = pop.client_groups()
    assign = np.array([eng.client_cohort(c) for c in range(pop.n_clients)])
    print("\ncohort composition (latent group -> count):")
    composition = {}
    for leaf in sorted(set(assign)):
        g = groups[assign == leaf]
        composition[leaf] = np.bincount(g, minlength=pop.n_groups).tolist()
        print(f"  cohort {leaf}: {composition[leaf]}")
    gain = hist[-1]["acc_mean"] - base[-1]["acc_mean"]
    print(f"\nfinal accuracy: baseline {base[-1]['acc_mean']:.3f} -> "
          f"auxo {hist[-1]['acc_mean']:.3f}  (+{gain:.3f})")
    return {"base": base, "hist": hist, "composition": composition, "engine": eng}


if __name__ == "__main__":
    main()
