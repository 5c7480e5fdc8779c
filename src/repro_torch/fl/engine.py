"""Multi-cohort FL engine: the Auxo lifecycle (paper Fig. 6), on PyTorch.

Port of ``repro.fl.engine`` for the synchronous single-device round. Per
global round (``fl/pipeline.py``): ① matching, ②③ local training +
masked aggregation + server optimizer for every leaf cohort over the
stacked CohortBank, ④ clustering feedback, rewards and partitions.
Wall-clock is simulated from device-speed traces; resource = client·steps.

The engine runs on ``device`` (default "cuda"; constructing it without a
device on a host without CUDA raises). ``init_params`` (a dict of numpy
arrays) overrides the seeded init, so that a run can start from the JAX
package's exact initial weights.

Not in this slice: the sequential oracle, round overlap, cohort sharding
and the population store (their config values raise
``NotImplementedError``), churn and ``ftfa_eval``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.convert import params_from_numpy
from repro_torch.core.coordinator import CohortCoordinator
from repro_torch.core.criteria import PartitionCriteria
from repro_torch.core.selection import CohortSelector
from repro_torch.core.sketch import GradientSketcher
from repro_torch.data.availability import AvailabilityTrace, DeviceSpeeds
from repro_torch.data.plane import DataPlane, as_plane
from repro_torch.fl.algorithms import make_server_opt
from repro_torch.fl.client import local_train
from repro_torch.fl.pipeline import LATER, RoundPipeline


@dataclasses.dataclass
class FLConfig:
    rounds: int = 150
    participants_per_round: int = 100
    local_steps: int = 5
    batch_size: int = 32
    lr: float = 0.05
    algorithm: str = "fedyogi"
    server_lr: float = 0.05
    prox_mu: float = 0.0
    qfed_q: float = 0.0
    overcommit: float = 1.25
    use_availability: bool = True
    speed_sigma: float = 0.6
    eval_every: int = 5
    seed: int = 0
    # "batched" = one fused step per round; "sequential" is a later slice
    execution: str = "batched"
    # 0 = synchronous rounds; the depth-2 overlap is a later slice
    round_overlap: int = 0
    # cohort-parallel placement over several devices: a later slice
    cohort_shards: int = 0
    rows_per_shard: int = 0
    # a client id may hold at most ONE kept row per round unless set
    allow_cross_cohort_duplicates: bool = False
    # chunked population store (+ churn, warm re-arrivals): a later slice
    population_store: bool = False
    availability_mode: str = "compat"
    warm_rearrivals: bool = False
    # resilience knobs (§7.5)
    corrupt_frac: float = 0.0
    dp_clip: float = 0.0
    dp_sigma: float = 0.0
    affinity_loss_rate: float = 0.0


@dataclasses.dataclass
class AuxoConfig:
    enabled: bool = True
    d_sketch: int = 64
    cluster_k: int = 2
    max_cohorts: int = 8
    gamma: float = 0.2
    epsilon0: float = 0.8
    epsilon_decay: float = 0.93
    clustering_start_frac: float = 0.05
    partition_start_frac: float = 0.15
    partition_end_frac: float = 0.85
    sketch_strategy: str = "auto"  # auto -> task.head_paths if defined
    # resolve check-ins by prototype descent over the client's EMA
    # fingerprint (beyond-paper, ablated in benchmarks/table5)
    assisted_matching: bool = True
    reward_stick: float = 1.1
    neg_streak_explore: int = 2
    fp_decay_on_streak: float = 1.0
    # eval-time routing: serve the ROOT model for unconfident matches
    serve_confidence: float = 0.05
    # never-trained clients compute a one-shot probe fingerprint at serve time
    probe_serving: bool = True
    min_members: int = 15
    margin_threshold: float = 0.4
    het_reduction_slack: float = 2.0
    alpha: float = 1.0


@dataclasses.dataclass
class CohortModel:
    """Host-side view of one bank slot (params/opt live stacked in the bank)."""

    params: Any
    opt_state: Any
    clock: float = 0.0
    rounds: int = 0


class DictProbeCache(dict):
    """Plain-dict probe-fingerprint cache (copy of the JAX package's)."""

    def missing(self, cs) -> np.ndarray:
        return np.array([c for c in cs if int(c) not in self], np.int64)

    def put(self, cs, rows: np.ndarray):
        for j, c in enumerate(cs):
            self[int(c)] = rows[j]

    def get_many(self, cs) -> np.ndarray:
        return np.stack([self[int(c)] for c in cs])

    def drop(self, cs):
        for c in cs:
            self.pop(int(c), None)


class AuxoEngine:
    def __init__(
        self,
        task,
        population,  # a DataPlane, or a FederatedClassification to wrap
        fl: FLConfig,
        auxo: Optional[AuxoConfig] = None,
        *,
        device=None,
        init_params: Optional[Dict[str, np.ndarray]] = None,
    ):
        if fl.population_store or fl.warm_rearrivals:
            raise NotImplementedError(f"population_store / warm_rearrivals: {LATER}")
        self.device = resolve_device(device)
        self.task = task
        self.data: DataPlane = as_plane(population)
        self.fl = fl
        self.auxo = auxo or AuxoConfig(enabled=False)
        self.rng = np.random.default_rng(fl.seed)
        if init_params is None:
            self._init_params = task.init(rnd.key(fl.seed, device=self.device))
        else:
            self._init_params = params_from_numpy(init_params, self.device)
        self.server_opt = make_server_opt(fl.algorithm, lr=fl.server_lr)
        self.coordinator = CohortCoordinator(
            d_sketch=self.auxo.d_sketch,
            cluster_k=self.auxo.cluster_k,
            criteria=PartitionCriteria(
                k=self.auxo.cluster_k,
                alpha=self.auxo.alpha,
                min_members=self.auxo.min_members,
                start_frac=self.auxo.partition_start_frac,
                end_frac=self.auxo.partition_end_frac,
                margin_threshold=self.auxo.margin_threshold,
                het_reduction_slack=self.auxo.het_reduction_slack,
            ),
            clustering_start_frac=self.auxo.clustering_start_frac,
            max_cohorts=self.auxo.max_cohorts,
            seed=fl.seed,
            device=self.device,
        )
        self.selector = CohortSelector(epsilon0=self.auxo.epsilon0, decay=self.auxo.epsilon_decay)
        head_paths = getattr(task, "head_paths", None)
        if self.auxo.sketch_strategy == "auto" and head_paths:
            # cluster on the classifier-head gradients (the label-skew
            # fingerprint)
            self.sketcher = GradientSketcher(
                d_sketch=self.auxo.d_sketch, strategy="last_block_proj",
                path_filter=tuple(head_paths),
            )
        else:
            strat = "full_proj" if self.auxo.sketch_strategy == "auto" else self.auxo.sketch_strategy
            self.sketcher = GradientSketcher(d_sketch=self.auxo.d_sketch, strategy=strat)
        self.trace = AvailabilityTrace(self.data.n_clients, seed=fl.seed)
        self.speeds = DeviceSpeeds(self.data.n_clients, sigma=fl.speed_sigma, seed=fl.seed)
        n_corrupt = int(fl.corrupt_frac * self.data.n_clients)
        self.corrupted = (
            set(self.rng.choice(self.data.n_clients, n_corrupt, replace=False).tolist())
            if n_corrupt else set()
        )
        self.history: List[Dict[str, Any]] = []
        self.resource_used = 0.0  # client local steps × batch (sample count)
        # client-held gradient fingerprints: EMA of centered+normalized
        # per-round sketches (soft state, §5.1); host numpy as in JAX
        self.fingerprint = np.zeros((self.data.n_clients, self.auxo.d_sketch), np.float32)
        self.fp_seen = np.zeros(self.data.n_clients, bool)
        self.neg_streak = np.zeros(self.data.n_clients, np.int32)
        self.fp_beta = 0.4
        # cross-cohort sketch mean EMA (the global centering reference)
        self.global_mu = np.zeros(self.auxo.d_sketch, np.float32)
        self.global_mu_seen = False
        self._probe_cache = DictProbeCache()
        self._probe_cache_key = -1
        self.probe_train_dispatches = 0  # batched probe trainings run
        self.pipeline = RoundPipeline(self, mode=fl.execution)

    # -------------------------------------------------------------- views
    @property
    def cohorts(self) -> Dict[str, CohortModel]:
        """Per-cohort model view over the stacked CohortBank."""
        bank = self.pipeline.bank
        return {
            cid: CohortModel(
                params=bank.params_of(cid),
                opt_state=bank.opt_state_of(cid),
                clock=float(bank.clock[slot]),
                rounds=int(bank.rounds[slot]),
            )
            for cid, slot in bank.slot_of.items()
        }

    def preferred_cohort(self, c: int) -> Optional[str]:
        bank = self.pipeline.bank
        leaves = self.coordinator.tree.leaves()
        slots = np.array([bank.slot_of[l] for l in leaves])
        slot = self.pipeline.table.preferred_slot(c, slots)
        return None if slot is None else bank.id_of[slot]

    # ------------------------------------------------------------------ API
    def run(self) -> List[Dict[str, Any]]:
        for r in range(self.fl.rounds):
            self.step(r)
            if r % self.fl.eval_every == 0 or r == self.fl.rounds - 1:
                self.history.append(self.evaluate(r))
        return self.history

    def step(self, r: int):
        """One global round: MatchPlan → BatchedExecution → FeedbackBatch."""
        self.pipeline.run_round(r)

    # ----------------------------------------------------------------- eval
    def _probe_fingerprints(self, cs: np.ndarray, root_params=None) -> np.ndarray:
        """Serve-time probe fingerprints for never-trained clients: each
        cache miss runs its local steps against the ROOT model, all misses
        in one batched training pass; sketches are centered on the global
        reference mean. Cached, and invalidated when the tree partitions."""
        key = len(self.coordinator.partitions)
        if key != self._probe_cache_key:
            self._probe_cache.clear()
            self._probe_cache_key = key
        cs = np.asarray(cs, np.int64)
        miss = self._probe_cache.missing(cs)
        if miss.size:
            n = miss.size
            xs, ys = self.data.probe_batches(miss, self.fl.batch_size, self.fl.local_steps)
            if root_params is None:
                root_params = self.pipeline.bank.params_of("0")
            self.probe_train_dispatches += 1
            rows = {k: v[None].expand((n,) + tuple(v.shape)) for k, v in root_params.items()}
            with torch.no_grad():
                deltas, _ = local_train(
                    self.task.loss, rows,
                    torch.from_numpy(xs).to(self.device),
                    torch.from_numpy(ys).to(self.device),
                    lr=self.fl.lr,
                )
                sk = self.sketcher.batch(deltas).cpu().numpy()
            ctr = sk - self.global_mu[None, :]
            ctr /= np.linalg.norm(ctr, axis=1, keepdims=True) + 1e-9
            self._probe_cache.put(miss, ctr.astype(np.float32))
        return self._probe_cache.get_many(cs)

    def serving_cohorts(self, clients=None) -> List[str]:
        """Cohorts whose models SERVE the given clients (default: all):
        fingerprint identity matching (one matrix product), an unconfident
        match falls back to the root; clients without a training
        fingerprint probe one; unconfident training fingerprints retry once
        with a fresh probe."""
        cs = (
            np.arange(self.data.n_clients, dtype=np.int64)
            if clients is None
            else np.asarray(clients, np.int64)
        )
        can_probe = (
            self.auxo.enabled
            and self.auxo.probe_serving
            and self.global_mu_seen
            and len(self.coordinator.identity) >= 2
        )
        have = self.fp_seen[cs]
        fps = np.zeros((cs.size, self.auxo.d_sketch), np.float32)
        fps[have] = self.fingerprint[cs[have]]
        need_probe = ~have if can_probe else np.zeros(cs.size, bool)
        if need_probe.any():
            fps[need_probe] = self._probe_fingerprints(cs[need_probe])
        has_fp = have | need_probe
        out: List[Optional[str]] = [None] * cs.size
        if has_fp.any():
            sub = np.flatnonzero(has_fp)
            best, margin, leaves = self.coordinator.match_many(fps[sub])
            if leaves:
                conf = self.auxo.serve_confidence
                if can_probe:
                    retry = have[sub] & (margin < conf)
                    if retry.any():
                        for c in cs[sub[retry]]:
                            self._probe_cache.pop(int(c), None)
                        pf = self._probe_fingerprints(cs[sub[retry]])
                        b2, m2, _ = self.coordinator.match_many(pf)
                        best[retry], margin[retry] = b2, m2
                for j, i in enumerate(sub):
                    out[i] = leaves[best[j]] if margin[j] >= conf else "0"
        for i in range(cs.size):
            if out[i] is None:
                c = int(cs[i])
                pref = self.preferred_cohort(c) or "0"
                out[i] = self.coordinator.match_request(c, pref, -1) or "0"
        return out

    def client_cohort(self, c: int) -> str:
        return self.serving_cohorts(np.array([c], np.int64))[0]

    def evaluate(self, r: int) -> Dict[str, Any]:
        leaves = self.coordinator.tree.leaves()
        cohorts = self.cohorts
        serving = self.serving_cohorts()
        tx, ty = self.data.eval_batches()  # stacked per-group test sets
        accs_by = {}
        with torch.no_grad():
            for cid in set(serving) | set(leaves):
                p = cohorts[cid].params
                accs_by[cid] = {
                    g: self.task.accuracy(p, tx[g], ty[g]) for g in range(self.data.n_groups)
                }
        groups = self.data.client_groups(np.arange(self.data.n_clients, dtype=np.int64))
        per_client = np.array(
            [accs_by[serving[c]][int(groups[c])] for c in range(self.data.n_clients)]
        )
        srt = np.sort(per_client)
        n10 = max(1, len(srt) // 10)
        clock = max(cm.clock for l, cm in cohorts.items() if l in leaves)
        return {
            "round": r,
            "time": clock,
            "resource": self.resource_used,
            "acc_mean": float(per_client.mean()),
            "acc_worst10": float(srt[:n10].mean()),
            "acc_best10": float(srt[-n10:].mean()),
            "acc_var": float(per_client.var() * 1e4),
            "n_cohorts": len(leaves),
            "cohort_accs": {l: float(np.mean(list(a.values()))) for l, a in accs_by.items()},
            "per_client": per_client,
        }


def run_fl(task, population, fl: FLConfig, *, device=None, init_params=None) -> List[Dict[str, Any]]:
    """Cohort-agnostic baseline (single global model)."""
    return AuxoEngine(
        task, population, fl, AuxoConfig(enabled=False), device=device, init_params=init_params
    ).run()


def run_auxo(
    task, population, fl: FLConfig, auxo: Optional[AuxoConfig] = None, *,
    device=None, init_params=None,
) -> Tuple[AuxoEngine, List[Dict[str, Any]]]:
    eng = AuxoEngine(task, population, fl, auxo or AuxoConfig(), device=device, init_params=init_params)
    hist = eng.run()
    return eng, hist
