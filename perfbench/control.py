"""Readings that set a cell's limits, outside the benchmark's own runs.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13 [--modes program,control,half_batch]

For each seed, each mode's numbers against the float32 reference of that
seed, at the cell's own sizes (run it on the chip):

- ``program``: the program as the benchmark drives it (its set-up steps;
  decode: one whole wave), the lower readings;
- ``control``: the reference itself in the program's place, in the next
  precision below the configuration's (TF32 for float32 with TF32 off);
- ``half_batch`` (training cells): the program on half of each client's
  sequences, the mean taken over the rest;
- ``cluster_unchanged`` (training cells): the program with a clustering
  update that returns its state unchanged;
- ``ulp`` (training cells): the reference from weights moved by one
  float32 ulp, a witness of what rounding alone does to each number.

Prints one JSON line per seed and mode: its numbers, and ``correct`` as a
run decides it, every number at or under its limit in
``perfbench/limits/<workload>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(workload: str, seed: int, modes, device: str = "cuda", config: dict = None):
    import torch

    from perfbench.entries import common
    from perfbench.lib import manifest

    man = manifest.load()
    wl = manifest.workload(man, workload)
    cfg = config or manifest.config(man, wl["config"])
    tr = manifest.traffic(wl["traffic"])
    entry = manifest.entry(tr["entry"])
    dev = torch.device(device)
    out = {}
    if tr["entry"] == "fl_round":
        from perfbench.reference import fl_round as ref

        from perfbench.lib import traffic as trf

        def batch(i):
            return trf.train_batch(seed, i, tr, cfg["vocab_size"])

        for mode in [m for m in modes if m in ("program", "half_batch", "cluster_unchanged")]:
            ctx = types.SimpleNamespace(config=cfg, traffic=tr, seed=seed, device=dev, trace=False,
                                        fault=None if mode == "program" else mode, workload=workload)
            cell = entry.setup(ctx)
            mine = cell.readings
            cell.close()
            del cell
            out[mode] = mine
        theirs = ref.readings(cfg, tr, seed, dev, batch, entry.SETUP_STEPS)
        mine = out.get("program")
        if mine is not None:  # the sketch stage: the program's own inputs
            theirs["sketches"] = entry.project_rows(mine, dev)
        for mode, tf32, ulps in (("control", True, 0), ("ulp", False, 1)):
            if mode in modes:
                r = ref.readings(cfg, tr, seed, dev, batch, entry.SETUP_STEPS, tf32=tf32, ulps=ulps)
                if mine is not None:  # the reference in the program's place on the same inputs
                    r["sketches"] = entry.project_rows(mine, dev, tf32=tf32)
                out[mode] = r
        common.free()
        # each mode's own stages: a fault's own sketch inputs, every mode's own rounds
        return {m: entry.compare(r, entry.stages(r, theirs, dev, project=m != "program"))
                for m, r in out.items()}
    from perfbench.reference import decode as ref

    ctx = types.SimpleNamespace(config=cfg, traffic=tr, seed=seed, device=dev, trace=False, fault=None,
                                workload=workload)
    cell = entry.setup(ctx)
    cell.window = True
    cell.step()
    cell.finish()
    reqs = cell.requests()
    cell.close()
    del cell
    got = ref.readings(cfg, tr, seed, dev, reqs, control="control" in modes)
    common.free()
    res = {"program": {k: got[k] for k in ("token_gap", "logit_gap")}}
    if "control" in got:
        res["control"] = got["control"]
    return res


def judged(workload: str, numbers: dict) -> dict:
    """``correct`` as a run decides it: every number at or under its limit."""
    from perfbench.lib import manifest

    limits = manifest.limits(workload)
    return {"correct": all(numbers.get(k, float("inf")) <= v for k, v in limits.items()), "limits": limits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control,half_batch")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no card"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = readings(args.workload, seed, args.modes.split(","))
        for mode, nums in res.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode, "numbers": nums,
                              **judged(args.workload, nums), "seconds": time.perf_counter() - t0,
                              "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
