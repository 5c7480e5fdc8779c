"""Plain reference of Auxo's federated LM round, as the paper and the
port's step define it:

1. each client copies the model and runs local SGD on its sequences
   (``local_steps`` micro-batches, the gradient's global norm clipped to
   ``clip_norm``), its delta being the trained copy minus the model;
2. each delta is sketched: the last block of every stacked leaf and the
   final norm, each leaf projected by Rademacher matrices of at most 2**16
   rows drawn from ``seed * 7919 + i`` for selected leaf i, scaled by
   1/sqrt(n), summed over the leaves;
3. Auxo's clustering round on the sketches: center, normalize, assign to
   the nearest centroid (bootstrapped from the two most anti-correlated
   rows), EMA refresh, instant rewards 1 - D/(mean(D) + std(D));
4. the reward-weighted mean of the deltas (weights clamp(r, 0) + 1e-3,
   normalized) feeds FedYoGi.

It reads the benchmark's weights and batches, never the program's state.
``readings`` gives what ``correct`` compares: each step's loss, the first
step's sketches, each leaf's norm of the first aggregated delta, each
leaf's norm of the change after the steps, and each round's clustering
(its sketches, assignments, counts and centroids). ``cluster_rounds``
runs step 3 alone on given sketches, from the initial state.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench.lib import weights as wts
from perfbench.reference import dense_lm, threefry

SKETCH_SEED = 1234
BETA1, BETA2, TAU = 0.9, 0.99, 1e-3


def block_size(n: int) -> int:
    """Projection block: at most 2**16 rows, halved for small leaves (>= 128)."""
    block = 1 << 16
    while block > 128 and block // 2 >= n:
        block //= 2
    return block


def take(name: str, t: torch.Tensor, lead: int = 0):
    """What the last-block sketch projects of leaf ``name`` (``t`` with
    ``lead`` leading row axes): the final norm (or a head) whole, the last
    layer of a stacked backbone leaf, nothing of the rest."""
    if "final_norm" in name or "head" in name:
        return t
    if name.startswith("backbone") and t.dim() - lead >= 2:
        return t[(slice(None),) * lead + (-1,)]
    return None


def project(rows: List[torch.Tensor], d: int) -> torch.Tensor:
    """(C, d) sketches of the selected leaves' (C, n) rows, in leaf order:
    leaf i projected by Rademacher blocks drawn from ``seed * 7919 + i``,
    scaled by 1/sqrt(n), summed over the leaves."""
    acc = None
    for i, r in enumerate(rows):
        r = r.float()
        n = r.shape[1]
        block = block_size(n)
        key = threefry.key(SKETCH_SEED * 7919 + i)
        proj = torch.zeros(r.shape[0], d, dtype=torch.float32, device=r.device)
        for b in range(-(-n // block)):
            part = r[:, b * block:(b + 1) * block]
            if part.shape[1] < block:
                part = torch.nn.functional.pad(part, (0, block - part.shape[1]))
            proj += part @ threefry.rademacher(threefry.fold_in(key, b), block, d, r.device)
        proj /= math.sqrt(n)
        acc = proj if acc is None else acc + proj
    return acc


def sketch(deltas: List[Dict[str, torch.Tensor]], d: int) -> torch.Tensor:
    """(C, d) sketches of the clients' deltas."""
    rows = [torch.stack([take(n, dl[n]).reshape(-1) for dl in deltas])
            for n in sorted(deltas[0]) if take(n, deltas[0][n]) is not None]
    return project(rows, d)


def clustering(state: Dict[str, torch.Tensor], x: torch.Tensor, ema: float = 0.3):
    """One clustering round; returns (new state, rewards, assignments, the
    round's counts)."""
    C, k = x.shape[0], state["centroids"].shape[0]
    mu = x.mean(dim=0, keepdim=True)
    xc = x - mu
    xn = xc / (torch.linalg.vector_norm(xc, dim=1, keepdim=True) + 1e-8)
    if state["initialized"]:
        cents = state["centroids"]
    else:
        sims = xn @ xn.T
        s0 = int(torch.argmax(sims.sum(dim=1)))
        s1 = int(torch.argmin(sims[s0]))
        cents = xn[[s0, s1] + [(s0 + i) % C for i in range(2, k)]]
    assign = torch.argmax(xn @ cents.T, dim=1)
    sums = torch.zeros_like(cents)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    for j in range(k):
        sel = assign == j
        sums[j] = xn[sel].sum(dim=0)
        counts[j] = sel.sum()
    batch = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), cents)
    new = (1 - ema) * cents + ema * batch
    new = new / (torch.linalg.vector_norm(new, dim=1, keepdim=True) + 1e-8)
    dist = torch.linalg.vector_norm(x - mu, dim=1)
    thr = dist.mean() + dist.std(correction=0)
    rewards = 1.0 - dist / torch.clamp(thr, min=1e-9)
    return ({"centroids": new, "counts": state["counts"] + counts, "initialized": True},
            rewards, assign, counts)


def init_state(k: int, d: int, device) -> Dict[str, torch.Tensor]:
    return {"centroids": torch.zeros(k, d, device=device), "counts": torch.zeros(k, device=device),
            "initialized": False}


def round_record(x, state, assign, counts) -> dict:
    """One round's clustering on the host: its sketches and what it made."""
    return {"sketches": x.cpu().numpy(), "assign": assign.cpu().numpy(),
            "counts": counts.cpu().numpy(), "centroids": state["centroids"].cpu().numpy()}


def cluster_rounds(sketches: List[np.ndarray], k: int, device) -> dict:
    """Step 3 alone over each round's given (C, d) sketches, from the
    initial state: each round's record and the final counts."""
    state = init_state(k, sketches[0].shape[1], device) if sketches else None
    rounds = []
    for x in sketches:
        x = torch.from_numpy(x).to(device)
        state, _, assign, counts = clustering(state, x)
        rounds.append(round_record(x, state, assign, counts))
    return {"rounds": rounds, "counts": state["counts"].cpu().numpy() if state else np.zeros(k)}


def yogi(p, m, v, d, lr: float):
    """FedYoGi on one leaf, in place."""
    m.mul_(BETA1).add_(d * (1 - BETA1))
    dd = d * d
    v.sub_((1 - BETA2) * dd * torch.sign(v - dd))
    p.add_(lr * m / (torch.sqrt(v) + TAU))


def client_delta(cfg: dict, tr: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 losses: list) -> Dict[str, torch.Tensor]:
    """One client's local SGD on a copy of ``params``; returns its delta."""
    work = {n: t.clone() for n, t in params.items()}
    m = tokens.shape[0]
    ls = tr["local_steps"] if m % tr["local_steps"] == 0 else 1
    mb = m // ls
    mine = []
    for i in range(ls):
        loss, views, grads = dense_lm.loss_and_grads(cfg, work, tokens[i * mb:(i + 1) * mb])
        with torch.no_grad():
            gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(tr["clip_norm"] / torch.clamp(gn, min=1e-9), max=1.0)
            for w, g in zip(views, grads):
                w.sub_(g * scale * tr["client_lr"])
        del views, grads
        mine.append(loss)
    losses.append(torch.stack(mine).mean())
    with torch.no_grad():
        for n in work:
            work[n].sub_(params[n])
    return work


def readings(cfg: dict, tr: dict, seed: int, device, batch_of: Callable[[int], np.ndarray],
             n_steps: int = 3, tf32: bool = False, ulps: int = 0) -> dict:
    """Run ``n_steps`` rounds from the seed's weights on batches
    ``batch_of(0..n_steps-1)``; the numbers ``correct`` compares. ``ulps``
    moves every starting weight by that many float32 ulps (a witness of
    what rounding alone does to the numbers)."""

    def start():
        w = wts.make(cfg, seed, device)
        for t in w.values():
            t.mul_(1 + ulps * 2.0 ** -23)
        return w

    dense_lm.precision(tf32)
    try:
        params = start()
        names = sorted(params)
        m = {n: torch.zeros_like(t) for n, t in params.items()}
        v = {n: torch.full_like(t, 1e-6) for n, t in params.items()}
        k, d = tr["cluster_k"], tr["d_sketch"]
        state = init_state(k, d, device)
        out = {"loss": [], "grad": {}, "change": {}, "rounds": []}
        for step in range(n_steps):
            toks = torch.from_numpy(batch_of(step)).to(device)
            losses: list = []
            deltas = [client_delta(cfg, tr, params, toks[c], losses) for c in range(toks.shape[0])]
            out["loss"].append(float(torch.stack(losses).mean()))
            with torch.no_grad():
                sk = sketch(deltas, d)
                if step == 0:
                    out["sketches"] = sk.cpu().numpy()
                state, rewards, assign, counts = clustering(state, sk)
                out["rounds"].append(round_record(sk, state, assign, counts))
                w = torch.clamp(rewards, min=0.0) + 1e-3
                w = w / w.sum()
                for n in names:
                    agg = torch.zeros_like(params[n])
                    for c, dl in enumerate(deltas):
                        agg += w[c] * dl.pop(n)
                    if step == 0:
                        out["grad"][n] = float(torch.linalg.vector_norm(agg))
                    yogi(params[n], m[n], v[n], agg, tr["server_lr"])
                    del agg
            del deltas
        del m, v
        first = start()
        with torch.no_grad():
            for n in names:
                out["change"][n] = float(torch.linalg.vector_norm(params[n] - first[n]))
        out["centroids"] = state["centroids"].cpu().numpy()
        out["counts"] = state["counts"].cpu().numpy()
        return out
    finally:
        dense_lm.precision(False)
