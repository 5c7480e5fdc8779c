"""Single-device training driver: the Auxo federated LM round step
(``launch.steps.make_train_step``) on one device (port of
``repro.launch.train``, without its mesh and shardings).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --d-model 512 --layers 8 --rounds 100 --checkpoint-every 50

The device is the card unless ``--device cpu`` is given. Checkpoints cover
params, optimizer and clustering state (cohort failover, §5.2), as
``.npz`` files the JAX package's ``load_pytree`` reads too.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.launch.steps import StepConfig, clustering_init, make_train_step, yogi_init
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).replace(
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=8,
        n_kv_heads=4,
        d_ff=4 * args.d_model,
        vocab=args.vocab,
        ce_chunk=128,
        attn_qchunk=0,
    )
    model = build_model(cfg)
    print(f"{args.arch}: {model.param_count()/1e6:.1f}M params on {dev}")

    sc = StepConfig(local_steps=2, client_lr=0.05, server_lr=0.03, d_sketch=128)
    step = make_train_step(model, sc)

    params = model.init(rnd.key(0), device=dev)
    opt = yogi_init(params)
    clust = clustering_init(sc.cluster_k, sc.d_sketch, device=dev)

    ckpt = Path(args.ckpt_dir)
    if args.resume and (ckpt / "params.npz").exists():
        params = load_pytree(ckpt / "params.npz", params)
        opt = load_pytree(ckpt / "opt.npz", opt)
        clust = load_pytree(ckpt / "clust.npz", clust)
        print("resumed from", ckpt)

    rng = np.random.default_rng(0)
    m = 2
    t0 = time.time()
    metrics = {}
    for r in range(args.rounds):
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, size=(args.clients, m, args.seq)).astype(np.int32)
        ).to(dev)
        params, opt, clust, metrics = step(params, opt, clust, {"tokens": toks})
        if r % max(1, args.rounds // 10) == 0:
            print(
                f"round {r:4d} loss {float(metrics['loss']):.4f} "
                f"disp {float(metrics['dispersion']):.3f} ({time.time()-t0:.0f}s)"
            )
        if args.checkpoint_every and (r + 1) % args.checkpoint_every == 0:
            ckpt.mkdir(parents=True, exist_ok=True)
            save_pytree(ckpt / "params.npz", params)
            save_pytree(ckpt / "opt.npz", opt)
            save_pytree(ckpt / "clust.npz", clust)
            print("checkpointed at round", r)
    print("done")
    return params, opt, clust, metrics


if __name__ == "__main__":
    main()
