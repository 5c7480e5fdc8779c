"""Training driver: the Auxo federated LM round step
(``launch.steps.make_train_step``), port of ``repro.launch.train``.

Run alone, it trains on one device (the card unless ``--device cpu`` is
given). Started by ``torchrun`` on more than one rank, it trains on every
rank as the reference trains on its local devices: one process per card
(``LOCAL_RANK``), a process group (``nccl``, or ``gloo`` with ``--device
cpu``), the reference's (world, 1) ("data", "model") mesh, params under
``tp``, Yogi's m and v under ``fsdp``, the clustering state replicated and
the round's clients split over ``data``; the step runs on those DTensors.
Rank 0 prints and writes the checkpoints (whole tensors); ``--resume``
loads them on every rank and places them again. A 1-rank ``torchrun``
joins its group and trains as a run alone does, on plain tensors.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --d-model 512 --layers 8 --rounds 100 --checkpoint-every 50
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --d-model 64 --layers 2 --rounds 2

Every family the port has runs as the JAX driver runs it: ``--arch`` sets
the family, and the flags set width, depth and vocabulary (an MoE arch
keeps its experts, top-k and capacity; a VLM trains on text tokens alone,
and its M-RoPE sections need a head dim of 128, ``--d-model 1024``, as in
the JAX driver; audio takes (clients, m, n_codebooks, seq) tokens, where
the JAX driver's (clients, m, seq) do not fit its codebook embedding).
Checkpoints cover params, optimizer and clustering state (cohort
failover, §5.2), as ``.npz`` files the JAX package's ``load_pytree`` reads
too.
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
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshAxes, make_mesh
from repro_torch.launch.steps import StepConfig, clustering_init, make_train_step, yogi_init
from repro_torch.models import build_model
from repro_torch.utils import spmd
from repro_torch.utils.tree import leaves, tree_map


def _join(device):
    """Join ``torchrun``'s process group (``gloo`` on the CPU, else
    ``nccl`` with this rank on card ``LOCAL_RANK``): this rank's device."""
    import torch.distributed as dist

    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        dev = resolve_device(torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))))
        torch.cuda.set_device(dev)
        backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    return dev


def _whole(tree):
    """Every leaf as a whole tensor (a DTensor gathered on every rank)."""
    return tree_map(lambda t: t.full_tensor() if spmd.is_dtensor(t) else t, tree)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Federated LM rounds on one device, or on every rank torchrun starts.")
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
    if "WORLD_SIZE" not in os.environ:  # not started by torchrun
        return train(args, resolve_device(args.device))
    world = int(os.environ["WORLD_SIZE"])
    if args.clients % world:
        ap.error(f"--clients {args.clients} is not divisible by the world size {world}: "
                 "the round's clients split evenly over the data axis")
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    dev = _join(args.device)
    try:
        # the reference's (world, 1) ("data", "model") mesh; a world of 1 trains on plain tensors
        mesh = make_mesh((world, 1), ("data", "model"), dev.type) if world > 1 else None
        with implicit_replication():
            out = train(args, dev, mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def train(args, dev, mesh=None):
    """``args.rounds`` rounds on ``dev``, or on this rank's shards of
    ``mesh``: (params, opt, clust, metrics) of the last, whole tensors."""
    world = 1 if mesh is None else mesh.size()
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
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
    if cfg.family == "hybrid":
        cfg = cfg.replace(ssm_heads=8, attn_every=2)
    if cfg.family == "ssm":
        cfg = cfg.replace(slstm_every=2)
    model = build_model(cfg)
    say(f"{args.arch}: {model.param_count()/1e6:.1f}M params on {dev}")

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
        say("resumed from", ckpt)

    # the reference's placement: params under tp, Yogi's state under fsdp
    # (DTensor placements per leaf), and what one card holds under them
    axes = mesh if mesh is not None else MeshAxes(("data", "model"), {"data": 1, "model": 1})
    placement = {"params": shd.param_shardings(params, axes, "tp"),
                 "opt": {k: shd.param_shardings(v, axes, "fsdp") for k, v in opt.items()}}
    per_card = shd.per_card_bytes(params, axes, "tp") + sum(
        shd.per_card_bytes(v, axes, "fsdp") for v in opt.values())
    total = sum(a.numel() * a.element_size() for a in leaves(params) + leaves(opt["m"]) + leaves(opt["v"]))
    say(f"placement on a ({world}, 1) (data, model) mesh: {len(leaves(placement['params']))} param leaves, "
        f"{per_card / 1e6:.1f} of {total / 1e6:.1f} MB of params and optimizer state on "
        f"{'each card' if world > 1 else 'the card'}")
    if mesh is not None:
        params = tree_map(lambda a, p: spmd.place(a, mesh, p), params, placement["params"])
        opt = {k: tree_map(lambda a, p: spmd.place(a, mesh, p), v, placement["opt"][k]) for k, v in opt.items()}
        clust = tree_map(lambda a: spmd.place(a, mesh, shd.replicated(mesh)), clust)

    rng = np.random.default_rng(0)
    m = 2
    t0 = time.time()
    metrics = {}
    # audio: one token stream per codebook
    shape = (args.clients, m) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (args.seq,)
    for r in range(args.rounds):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=shape).astype(np.int32)).to(dev)
        if mesh is not None:  # the clients split over data
            toks = spmd.place(toks, mesh, shd.batch_shardings({"tokens": toks}, mesh)["tokens"])
        params, opt, clust, metrics = step(params, opt, clust, {"tokens": toks})
        if r % max(1, args.rounds // 10) == 0:
            got = _whole({k: metrics[k] for k in ("loss", "dispersion")})
            say(
                f"round {r:4d} loss {float(got['loss']):.4f} "
                f"disp {float(got['dispersion']):.3f} ({time.time()-t0:.0f}s)"
            )
        if args.checkpoint_every and (r + 1) % args.checkpoint_every == 0:
            state = _whole({"params": params, "opt": opt, "clust": clust})
            if rank0:
                ckpt.mkdir(parents=True, exist_ok=True)
                for name, tree in state.items():
                    save_pytree(ckpt / f"{name}.npz", tree)
            say("checkpointed at round", r)
    say("done")
    out = _whole({"params": params, "opt": opt, "clust": clust, "metrics": metrics})
    return out["params"], out["opt"], out["clust"], out["metrics"]


if __name__ == "__main__":
    main()
