"""Figure 12: Pearson correlation between pairwise gradient (sketch)
similarity and pairwise data similarity across training rounds — the
signal that determines the clustering start time (paper §4.4). A port of
``benchmarks/fig12_correlation.py``: where the reference calls its
engine's vmapped local training and sketch, this trains the root cohort's
params expanded to one row per client with ``fl.client.local_train`` and
sketches the rows with the engine's sketcher."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.fl import AuxoConfig
from repro_torch.fl.client import local_train
from repro_torch.fl.engine import AuxoEngine
from repro_torch.paper.common import build, default_fl, emit


def _pairwise_data_similarity(plane, ids):
    """Cosine similarity of client label+feature moment vectors.

    Moments estimate from each client's deterministic probe draws (the
    DataPlane API — no reach into per-client arrays), so the same code
    measures materialized and procedural populations.
    """
    xs, ys = plane.probe_batches(ids, batch=64, steps=4)
    feats = []
    for i in range(len(ids)):
        y = ys[i].ravel()
        hist = np.bincount(y, minlength=plane.n_classes) / y.size
        mean = xs[i].reshape(-1, plane.dim).mean(0)
        feats.append(np.concatenate([hist * 3.0, mean / (np.linalg.norm(mean) + 1e-9)]))
    F = np.stack(feats)
    F = F - F.mean(0)
    F /= np.linalg.norm(F, axis=1, keepdims=True) + 1e-9
    return F @ F.T


def _row_sketches(eng, ids, xs, ys, keys) -> np.ndarray:
    """(n, d_sketch) sketches of each client's delta from the root cohort's
    params, with the run's lr, prox and DP settings."""
    fl, dev = eng.fl, eng.device
    rows = {k: v[None].expand((len(ids),) + tuple(v.shape)) for k, v in eng.cohorts["0"].params.items()}
    with torch.no_grad():
        deltas, _ = local_train(
            eng.task.loss, rows, torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev), keys,
            lr=fl.lr, prox_mu=fl.prox_mu, dp_clip=fl.dp_clip, dp_sigma=fl.dp_sigma,
        )
        return eng.sketcher.batch(deltas).cpu().numpy()


def run(rounds: int = 60, *, device=None):
    task, pop = build("openimage-like")
    fl = default_fl(rounds, use_availability=False)
    eng = AuxoEngine(task, pop, fl, AuxoConfig(enabled=False, d_sketch=128), device=device)
    ids = np.arange(150, dtype=np.int64)
    D = _pairwise_data_similarity(eng.data, ids)
    iu = np.triu_indices(len(ids), k=1)

    rows = []
    for r in range(rounds):
        eng.step(r)
        if r % max(1, rounds // 8) != 0:
            continue
        xs, ys = eng.data.sample_batches(
            ids, fl.batch_size, fl.local_steps, eng.rng
        )
        keys = rnd.split(rnd.key(r, device=eng.device), len(ids))
        sk = _row_sketches(eng, ids, xs, ys, keys)
        sk = sk - sk.mean(0)
        sk /= np.linalg.norm(sk, axis=1, keepdims=True) + 1e-9
        G = sk @ sk.T
        r_pearson = np.corrcoef(G[iu], D[iu])[0, 1]
        rows.append(dict(round=r, pearson_r=float(r_pearson)))
    emit(rows, "Figure 12: gradient/data similarity correlation")
    return rows


if __name__ == "__main__":
    run()
