"""Clustered-FL baselines for the Table-5 comparison: IFCA, FL+HC, FlexCFL, CFL.

Port of ``repro.fl.baselines``. Each baseline reuses the same substrate
(local_train, server opts, data, device traces) so the comparison isolates
the *clustering mechanism*. Their documented limitations (Table 1) are
reproduced faithfully:

- IFCA  [22]: broadcasts ALL k models each round; every participant
  evaluates every model locally to pick the best — k× download and k×
  evaluation cost on-device, counted in the resource metric.
- FL+HC [11]: warm-up rounds of global FedAvg, then ONE full pass over the
  *entire* population (every client computes an update — huge one-shot
  cost), agglomerative clustering on those updates, then per-cluster FL.
- FlexCFL [16]: like FL+HC but clusters on pre-training updates at round 0
  (early partition) with static assignment.
- CFL   [67]: requires full participation every round; recursively
  bi-partitions when the aggregated update norm stalls. Impractical at
  scale; evaluated small-scale like the paper (§7.3).

The JAX package trains one client at a time; here the clients of a round
(of a cluster, for CFL) train as the rows of ONE ``local_train`` call, each
row from its own model. Host draws keep the reference's order exactly: a
round's batches are all drawn first, client by client (IFCA: the 1-step
evaluation batch, then the training batch), and trained afterwards. The
key the reference hands ``local_train`` is never read (no DP here), so
none is made. ``_agglomerative`` merges the reference's pairs in the
reference's order with its own pair means (numpy on the host), keeping
them across merges instead of recomputing every pair each merge.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.convert import params_from_numpy
from repro_torch.data.availability import DeviceSpeeds
from repro_torch.data.plane import as_plane
from repro_torch.fl.algorithms import make_server_opt
from repro_torch.fl.client import local_train
from repro_torch.fl.engine import FLConfig
from repro_torch.utils.tree import leaves, tree_map


def _rows_flat(deltas, width: Optional[int] = None) -> np.ndarray:
    """(R, n) numpy rows of stacked (R, ...) updates, each flattened in
    JAX's leaf order (sorted keys: for MLPTask ``b0, b1, b2, w0, ...``);
    ``width`` keeps only the first columns (copied from the device leaf by
    leaf until it is reached)."""
    parts, n = [], 0
    for l in leaves(deltas):
        if width is not None and n >= width:
            break
        parts.append(l.reshape(l.shape[0], -1).detach().cpu().numpy())
        n += parts[-1].shape[1]
    x = np.concatenate(parts, axis=1)
    return x if width is None else x[:, :width]


def _np_flat(delta) -> np.ndarray:
    """One unstacked update flattened like a row of ``_rows_flat``."""
    return _rows_flat(tree_map(lambda a: a[None], delta))[0]


def _agglomerative(x: np.ndarray, k: int, max_linkage: int = 250) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance (numpy).

    The naive linkage is O(n^3); beyond `max_linkage` points we run the
    linkage on a subsample and assign the rest to the nearest cluster mean
    (standard practice; FL+HC's own cost is dominated by the full-population
    update pass, which is still charged in full).
    """
    n = x.shape[0]
    if n > max_linkage:
        rng = np.random.default_rng(0)
        idx = rng.choice(n, max_linkage, replace=False)
        sub_labels = _agglomerative(x[idx], k, max_linkage)
        cents = np.stack([x[idx[sub_labels == c]].mean(0) for c in range(k)])
        cn = cents / (np.linalg.norm(cents, axis=1, keepdims=True) + 1e-9)
        xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
        return np.argmax(xn @ cn.T, axis=1).astype(np.int32)
    xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    sim = xn @ xn.T
    clusters: List[List[int]] = [[i] for i in range(n)]
    # link[i, j] (i < j) is the reference's np.mean(sim[ix_(clusters[i],
    # clusters[j])]), kept across merges: a merge recomputes only the merged
    # cluster's pairs, each with the same call on the same member lists in
    # the same orientation, so every value is the reference's bit for bit.
    # The first maximum in row-major order is the pair the reference's
    # (i, j) scan with a strict ">" keeps.
    link = np.where(np.triu(np.ones((n, n), bool), 1), sim, -np.inf)
    while len(clusters) > k:
        bi, bj = divmod(int(np.argmax(link)), len(clusters))
        if not link[bi, bj] > -np.inf:
            bi, bj = 0, 1
        clusters[bi] = clusters[bi] + clusters[bj]
        del clusters[bj]
        link = np.delete(np.delete(link, bj, axis=0), bj, axis=1)
        for c in range(len(clusters)):
            if c < bi:
                link[c, bi] = np.mean(sim[np.ix_(clusters[c], clusters[bi])])
            elif c > bi:
                link[bi, c] = np.mean(sim[np.ix_(clusters[bi], clusters[c])])
    out = np.zeros(n, np.int32)
    for ci, members in enumerate(clusters):
        out[members] = ci
    return out


def _copy(params):
    return tree_map(torch.clone, params)


class _Base:
    """Shared scaffolding: population, task, metrics, simulated clock.

    Client data flows ONLY through the §⑦ DataPlane protocol (a raw
    FederatedClassification wraps into a MaterializedDataPlane). Runs on
    ``device`` (default "cuda"; raises without a card). ``init_params``
    (numpy) overrides the seeded init: one dict, or for IFCA a list of k.
    ``agglomerative_s`` sums the host seconds of ``_agglomerative``.
    """

    def __init__(self, task, pop, fl: FLConfig, k: int, *, device=None, init_params=None):
        self.device = resolve_device(device)
        self.task = task
        self.pop = as_plane(pop)
        self.fl = fl
        self.k = k
        self.init_params = init_params
        self.rng = np.random.default_rng(fl.seed)
        self.resource = 0.0  # samples processed on-device
        self.comm = 0.0  # model-downloads equivalent
        self.clock = 0.0  # same simulated-seconds model as AuxoEngine
        self.speeds = DeviceSpeeds(self.pop.n_clients, sigma=fl.speed_sigma, seed=fl.seed)
        self.history: List[Dict[str, Any]] = []
        self.server_opt = make_server_opt(fl.algorithm, lr=fl.server_lr)
        self.agglomerative_s = 0.0

    def _init(self, i: Optional[int] = None):
        """The seeded init ``key(seed)`` (``fold_in(key, i)`` for IFCA's
        model i), or the caller's ``init_params``."""
        if self.init_params is not None:
            p = self.init_params if i is None else self.init_params[i]
            return params_from_numpy(p, self.device)
        key = rnd.key(self.fl.seed, device=self.device)
        return self.task.init(key if i is None else rnd.fold_in(key, i))

    def _advance_clock(self, participants, extra_frac: float = 0.0):
        """Round duration = slowest participant (no over-commitment: these
        baselines assume full success); extra_frac models added per-round
        overhead (e.g. IFCA's k-model broadcast + k local evaluations)."""
        work = self.fl.local_steps * self.fl.batch_size
        lat = max(self.speeds.speed[c] * work for c in participants)
        self.clock += lat * (1.0 + extra_frac)

    def _draw(self, c: int, steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """Client c's batches for ``steps`` steps, from the baseline's rng."""
        xb, yb = self.pop.sample_batches(np.array([c]), self.fl.batch_size, steps, self.rng)
        return xb[0], yb[0]

    def _train_rows(self, params_rows, xs: List[np.ndarray], ys: List[np.ndarray]):
        """Local training of one row per client, from stacked (R, ...)
        params: (deltas (R, ...), losses (R,)). Charges each row's samples
        to ``resource``, as the reference's per-client ``_client_delta``."""
        deltas, losses = local_train(
            self.task.loss, params_rows,
            torch.from_numpy(np.stack(xs)).to(self.device),
            torch.from_numpy(np.stack(ys)).to(self.device),
            lr=self.fl.lr,
        )
        self.resource += len(xs) * self.fl.local_steps * self.fl.batch_size
        return deltas, losses

    def _client_deltas(self, params_rows, cs: Sequence[int]):
        """Draw every client's batches in order, then train all rows."""
        drawn = [self._draw(int(c), self.fl.local_steps) for c in cs]
        return self._train_rows(params_rows, [x for x, _ in drawn], [y for _, y in drawn])

    def _rows_of(self, models: List[Any], which: np.ndarray):
        """Stacked (R, ...) params: row j is ``models[which[j]]``."""
        stack = tree_map(lambda *ls: torch.stack(ls), *models)
        idx = torch.as_tensor(np.asarray(which, np.int64), device=self.device)
        return tree_map(lambda a: a[idx], stack)

    @staticmethod
    def _expand(params, n: int):
        return tree_map(lambda a: a[None].expand((n,) + tuple(a.shape)), params)

    def _aggregate(self, params, opt_state, deltas, rows=None):
        """Mean of the selected delta rows (all by default), then the
        server optimizer."""
        sel = (lambda a: a) if rows is None else (
            lambda a: a[torch.as_tensor(np.asarray(rows, np.int64), device=self.device)]
        )
        agg = tree_map(lambda a: sel(a).mean(0), deltas)
        return self.server_opt.apply(params, opt_state, agg)

    def _agglomerate(self, x: np.ndarray, k: int) -> np.ndarray:
        t0 = time.perf_counter()
        out = _agglomerative(x, k)
        self.agglomerative_s += time.perf_counter() - t0
        return out

    def _eval(self, r: int, assignment: np.ndarray, models: List[Any]) -> Dict[str, Any]:
        per_client = np.zeros(self.pop.n_clients)
        tx, ty = self.pop.eval_batches()
        accs = {}
        with torch.no_grad():
            for ci in range(len(models)):
                accs[ci] = {
                    g: self.task.accuracy(models[ci], tx[g], ty[g])
                    for g in range(self.pop.n_groups)
                }
        groups = self.pop.client_groups(np.arange(self.pop.n_clients, dtype=np.int64))
        for c in range(self.pop.n_clients):
            per_client[c] = accs[int(assignment[c])][int(groups[c])]
        srt = np.sort(per_client)
        n10 = max(1, len(srt) // 10)
        rec = {
            "round": r,
            "time": self.clock,
            "resource": self.resource,
            "comm": self.comm,
            "acc_mean": float(per_client.mean()),
            "acc_worst10": float(srt[:n10].mean()),
            "acc_best10": float(srt[-n10:].mean()),
            "acc_var": float(per_client.var() * 1e4),
        }
        self.history.append(rec)
        return rec


class IFCA(_Base):
    """Ghosh et al., NeurIPS'20 — cluster by per-round model selection."""

    def run(self) -> List[Dict[str, Any]]:
        fl = self.fl
        models = [self._init(i) for i in range(self.k)]
        opts = [self.server_opt.init(m) for m in models]
        assignment = np.zeros(self.pop.n_clients, np.int32)

        for r in range(fl.rounds):
            part = self.rng.choice(self.pop.n_clients, fl.participants_per_round, replace=False)
            ex, ey, xs, ys = [], [], [], []
            for c in part:
                # client downloads ALL k models and evaluates each locally
                self.comm += self.k
                x, y = self._draw(int(c), 1)
                ex.append(x[0])
                ey.append(y[0])
                self.resource += self.k * fl.batch_size  # k local eval passes
                x, y = self._draw(int(c), fl.local_steps)
                xs.append(x)
                ys.append(y)
            bx = torch.from_numpy(np.stack(ex)).to(self.device)
            by = torch.from_numpy(np.stack(ey)).to(self.device)
            with torch.no_grad():  # (k, P) losses: model i over every client
                losses = torch.stack([
                    self.task.loss(self._expand(m, len(part)), (bx, by)) for m in models
                ]).cpu().numpy()
            best = np.argmin(losses, axis=0)
            assignment[part] = best
            deltas, _ = self._train_rows(self._rows_of(models, best), xs, ys)
            # k local eval passes = k/local_steps extra device time
            self._advance_clock(part, extra_frac=self.k / max(self.fl.local_steps, 1) * 0.5)
            for i in range(self.k):
                rows = np.flatnonzero(best == i)
                if rows.size:
                    models[i], opts[i] = self._aggregate(models[i], opts[i], deltas, rows)
            if r % fl.eval_every == 0 or r == fl.rounds - 1:
                self._eval(r, assignment, models)
        return self.history


class FLHC(_Base):
    """Briggs et al., IJCNN'20 — hierarchical clustering after warm-up."""

    def __init__(self, task, pop, fl, k, warmup_rounds: int = 10, *, device=None, init_params=None):
        super().__init__(task, pop, fl, k, device=device, init_params=init_params)
        self.warmup = warmup_rounds

    def run(self) -> List[Dict[str, Any]]:
        fl = self.fl
        params = self._init()
        opt = self.server_opt.init(params)
        assignment = np.zeros(self.pop.n_clients, np.int32)

        for r in range(self.warmup):
            part = self.rng.choice(self.pop.n_clients, fl.participants_per_round, replace=False)
            deltas, _ = self._client_deltas(self._expand(params, len(part)), part)
            params, opt = self._aggregate(params, opt, deltas)
            self._advance_clock(part)
            if r % fl.eval_every == 0:
                self._eval(r, assignment, [params])

        # the expensive full pass: EVERY client computes an update
        n = self.pop.n_clients
        deltas, _ = self._client_deltas(self._expand(params, n), range(n))
        # the full pass waits for the SLOWEST client in the population
        self._advance_clock(range(n))
        X = _rows_flat(deltas)
        del deltas
        X = X - X.mean(0)
        assignment = self._agglomerate(X[:, :256], self.k)

        models = [_copy(params) for _ in range(self.k)]
        opts = [self.server_opt.init(m) for m in models]
        for r in range(self.warmup, fl.rounds):
            part = self.rng.choice(self.pop.n_clients, fl.participants_per_round, replace=False)
            which = assignment[part]
            deltas, _ = self._client_deltas(self._rows_of(models, which), part)
            for i in range(self.k):
                rows = np.flatnonzero(which == i)
                if rows.size:
                    models[i], opts[i] = self._aggregate(models[i], opts[i], deltas, rows)
            self._advance_clock(part)
            if r % fl.eval_every == 0 or r == fl.rounds - 1:
                self._eval(r, assignment, models)
        return self.history


class FlexCFL(FLHC):
    """Duan et al., TPDS'21 — pre-training-based static groups at round 0."""

    def __init__(self, task, pop, fl, k, *, device=None, init_params=None):
        super().__init__(task, pop, fl, k, warmup_rounds=1, device=device, init_params=init_params)


class CFL(_Base):
    """Sattler et al., TNNLS'21 — recursive bi-partition, full participation."""

    def __init__(self, task, pop, fl, k, norm_eps: float = 0.4, *, device=None, init_params=None):
        super().__init__(task, pop, fl, k, device=device, init_params=init_params)
        self.norm_eps = norm_eps

    def run(self) -> List[Dict[str, Any]]:
        fl = self.fl
        # cluster set: (member ids, params, opt)
        params = self._init()
        clusters = [(list(range(self.pop.n_clients)), params, self.server_opt.init(params))]
        assignment = np.zeros(self.pop.n_clients, np.int32)

        for r in range(fl.rounds):
            new_clusters = []
            for members, params, opt in clusters:
                # FULL participation of the cluster every round
                deltas, _ = self._client_deltas(self._expand(params, len(members)), members)
                X = _rows_flat(deltas, 256)
                params, opt = self._aggregate(params, opt, deltas)
                mean_norm = np.linalg.norm(X.mean(0))
                max_norm = np.max(np.linalg.norm(X, axis=1))
                if (
                    len(new_clusters) + len(clusters) < self.k
                    and len(members) > 20
                    and mean_norm < self.norm_eps * max_norm
                    and r > 3
                ):
                    Xc = X - X.mean(0)
                    lab = self._agglomerate(Xc, 2)
                    a = [m for m, l in zip(members, lab) if l == 0]
                    b = [m for m, l in zip(members, lab) if l == 1]
                    if len(a) > 10 and len(b) > 10:
                        new_clusters.append((a, _copy(params), self.server_opt.init(params)))
                        new_clusters.append((b, _copy(params), self.server_opt.init(params)))
                        continue
                new_clusters.append((members, params, opt))
            clusters = new_clusters
            for ci, (members, _, _) in enumerate(clusters):
                assignment[members] = ci
            self._advance_clock(range(self.pop.n_clients))  # full participation
            if r % fl.eval_every == 0 or r == fl.rounds - 1:
                self._eval(r, assignment, [p for _, p, _ in clusters])
        return self.history
