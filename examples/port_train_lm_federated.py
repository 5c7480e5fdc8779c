"""End-to-end driver on the card: federated training of a ~100M-param LM
with the Auxo train step (the PyTorch port's
``examples/train_lm_federated.py``; the same ``make_train_step`` the dry
run plans for the production mesh).

A ~100M granite-family config trains for a few hundred FL rounds on a
synthetic non-IID token corpus with two latent client populations (distinct
token distributions). The in-step Auxo clustering separates them; the
printed cluster counts converge to the true group sizes. The round's
aggregation sums the clients' deltas per cluster with the segment kernel.

  PYTHONPATH=src python examples/port_train_lm_federated.py --rounds 300 [--device cpu]
Reduce --d-model/--layers/--rounds for a faster run.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.steps import (
    StepConfig,
    clustering_init,
    make_train_step,
    yogi_init,
)
from repro_torch.models import build_model


def synth_corpus(key, n_clients, m, seq, vocab, n_groups=2, phrase=64, noise=0.05):
    """Group-structured corpora: each group repeats its own random phrase
    (clients add token-substitution noise), so the LM can actually learn
    (low entropy) and client gradients carry a latent group signal."""
    rng = np.random.default_rng(0)
    phrases = [rng.integers(0, vocab, size=phrase) for _ in range(n_groups)]
    toks = np.zeros((n_clients, m, seq), np.int32)
    groups = np.arange(n_clients) % n_groups
    for c in range(n_clients):
        base = phrases[groups[c]]
        for j in range(m):
            off = rng.integers(0, phrase)
            row = np.tile(base, seq // phrase + 2)[off : off + seq].copy()
            flip = rng.random(seq) < noise
            row[flip] = rng.integers(0, vocab, size=flip.sum())
            toks[c, j] = row
    return torch.from_numpy(toks), groups


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--client-lr", type=float, default=0.3)
    ap.add_argument("--server-lr", type=float, default=0.3)
    ap.add_argument("--clip", type=float, default=10.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("granite-3-2b").replace(
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=8,
        n_kv_heads=4,
        d_ff=4 * args.d_model,
        vocab=args.vocab,
        tie_embeddings=True,
        attn_qchunk=0,
        ce_chunk=128,
    )
    model = build_model(cfg)
    print(f"params: {model.param_count()/1e6:.1f}M")

    sc = StepConfig(local_steps=2, client_lr=args.client_lr, server_lr=args.server_lr,
                    clip_norm=args.clip, d_sketch=128)
    step = make_train_step(model, sc)

    key = rnd.key(0, device=dev)
    params = model.init(key, device=dev)
    opt = yogi_init(params)
    clust = clustering_init(sc.cluster_k, sc.d_sketch, device=dev)

    m_per_client = 2
    toks, groups = synth_corpus(key, args.clients, m_per_client, args.seq, cfg.vocab)
    toks = toks.to(dev)
    print("latent groups:", np.bincount(groups).tolist())

    t0 = time.time()
    history = []
    for r in range(args.rounds):
        params, opt, clust, metrics = step(params, opt, clust, {"tokens": toks})
        if r % max(1, args.rounds // 20) == 0 or r == args.rounds - 1:
            counts = metrics["cluster_counts"].cpu().numpy().astype(int).tolist()
            history.append({"round": r, "loss": float(metrics["loss"]),
                            "dispersion": float(metrics["dispersion"]), "counts": counts})
            print(
                f"round {r:4d}  loss {float(metrics['loss']):.4f}  "
                f"dispersion {float(metrics['dispersion']):.3f}  "
                f"cluster sizes {counts}  ({time.time()-t0:.0f}s)"
            )
    print("done in", round(time.time() - t0), "s")
    return history


if __name__ == "__main__":
    main()
