#!/usr/bin/env python3
"""How far float32 rounding alone moves ``repro_torch.launch.train``.

Runs the driver alone (one device, plain tensors) for a few rounds from its
params as drawn, then once per seed from the same params with every element
moved one ulp up or down by a seeded coin: a change of the size that
another order of the same float32 sums makes. Prints each run's round
lines and, per seed, the largest |difference| of the last params, opt and
centroids from the first run's, and both runs' cluster counts, as one JSON
object per line.

    PYTHONPATH=src python3 tools/train_rounding.py [--device cpu] [--seeds 0 1] [--rounds 3] \\
        [-- more launch.train flags]

With no flags after ``--`` the driver keeps its default widths.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.launch import train
from repro_torch.utils.tree import tree_map


def one_ulp(params, seed: int):
    """Every float leaf of ``params`` moved one ulp up or down, by a seeded coin."""
    g = torch.Generator().manual_seed(seed)

    def move(a):
        if not a.dtype.is_floating_point:
            return a
        up = torch.randint(0, 2, a.shape, generator=g, dtype=torch.bool).to(a.device)
        return torch.nextafter(a, torch.where(up, torch.inf, -torch.inf).to(a.dtype))

    return tree_map(move, params)


def run(argv, ckpt: str, seed=None):
    """``launch.train`` alone into ``ckpt``; its params moved by ``one_ulp``
    when ``seed`` is given."""
    build = train.build_model

    def moved(cfg):
        model = build(cfg)
        init = model.init
        object.__setattr__(model, "init", lambda *a, **k: one_ulp(init(*a, **k), seed))
        return model

    train.build_model = build if seed is None else moved
    try:
        train.main(argv + ["--ckpt-dir", ckpt])
    finally:
        train.build_model = build


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    os.environ.pop("WORLD_SIZE", None)
    extra = [a for a in args.rest if a != "--"]
    base = ["--rounds", str(args.rounds), "--checkpoint-every", str(args.rounds)]
    base += (["--device", args.device] if args.device else []) + extra
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {}
        for seed in [None] + args.seeds:
            ckpts[seed] = os.path.join(tmp, f"seed{seed}")
            print(f"--- params {'as drawn' if seed is None else f'moved one ulp, seed {seed}'}", flush=True)
            run(base, ckpts[seed], seed)
        ref = {n: np.load(os.path.join(ckpts[None], f"{n}.npz")) for n in ("params", "opt", "clust")}
        for seed in args.seeds:
            got = {n: np.load(os.path.join(ckpts[seed], f"{n}.npz")) for n in ref}
            gap = {n: max(float(np.abs(got[n][k].astype(np.float64) - ref[n][k]).max())
                          for k in ref[n].files if ref[n][k].size and k != "['counts']")
                   for n in ref}
            print(json.dumps({"seed": seed, "max_abs": gap, "counts": got["clust"]["['counts']"].tolist(),
                              "counts_as_drawn": ref["clust"]["['counts']"].tolist()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
