"""Resilience walkthrough on the card (paper §5.2 / §7.5): Auxo under local
DP, label-poisoning clients, affinity loss, and a coordinator failover (the
PyTorch port's ``examples/robust_fl.py``).

Runs on the card unless ``--device cpu`` is given; ``--rounds`` and
``--clients`` shorten the run. The coordinator's checkpoint goes to a
temporary file.

  PYTHONPATH=src python examples/port_robust_fl.py [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.core.coordinator import CohortCoordinator
from repro_torch.data import make_population
from repro_torch.fl import AuxoConfig, FLConfig, MLPTask, run_auxo

SCENARIOS = [
    ("clean", {}),
    ("local DP (sigma=0.6)", dict(dp_clip=1.0, dp_sigma=0.6)),
    ("10% poisoned clients", dict(corrupt_frac=0.10)),
    ("10% affinity loss", dict(affinity_loss_rate=0.10)),
    ("pre-failover", {}),
]


def scenario(name, fl_kwargs, rounds=40, clients=500, device=None):
    pop = make_population(
        n_clients=clients, n_groups=2, group_sep=0.0, label_conflict=0.5, seed=7
    )
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    fl = FLConfig(rounds=rounds, participants_per_round=80, eval_every=39,
                  use_availability=False, seed=7, **fl_kwargs)
    auxo = AuxoConfig(d_sketch=64, cluster_k=2, max_cohorts=2,
                      clustering_start_frac=0.05, partition_start_frac=0.1,
                      min_members=8)
    eng, hist = run_auxo(task, pop, fl, auxo, device=device)
    print(f"{name:28s} final acc {hist[-1]['acc_mean']:.3f} "
          f"cohorts {hist[-1]['n_cohorts']} blacklisted {len(eng.coordinator.blacklist)}")
    return eng, hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=500)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    runs = {name: scenario(name, kw, args.rounds, args.clients, dev) for name, kw in SCENARIOS}
    eng = runs["pre-failover"][0]

    # coordinator failover: checkpoint -> crash -> recover (§5.2)
    fd, ckpt = tempfile.mkstemp(prefix="auxo_coord_", suffix=".ckpt")
    os.close(fd)
    try:
        eng.coordinator.checkpoint(ckpt)
        co2 = CohortCoordinator.recover(ckpt, device=dev)
    finally:
        os.remove(ckpt)
    assert set(co2.tree.leaves()) == set(eng.coordinator.tree.leaves())
    print("coordinator failover: tree restored with leaves", co2.tree.leaves())

    # soft-state rebuild purely from client affinity requests (§5.1)
    reqs = []
    for c in range(0, 200):
        pref = eng.preferred_cohort(c)
        if pref:
            reqs.append((c, pref, max(0, eng.client_cluster_index(c, pref))))
    co3 = CohortCoordinator(d_sketch=64, device=dev)
    co3.rebuild_from_requests(reqs)
    print("soft-state rebuild from", len(reqs), "client requests ->", co3.tree.leaves())
    return {"runs": runs, "recovered": co2.tree.leaves(), "rebuilt": co3.tree.leaves(), "requests": reqs}


if __name__ == "__main__":
    main()
