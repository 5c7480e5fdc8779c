"""Multi-cohort FL engine: the Auxo lifecycle (paper Fig. 6), on PyTorch.

Port of ``repro.fl.engine``. Per global round
(``fl/pipeline.py``): ① matching, ②③ local training + masked aggregation
+ server optimizer for every leaf cohort over the stacked CohortBank, ④
clustering feedback, rewards and partitions. Wall-clock is simulated from
device-speed traces; resource = client·steps.

Modes, as in the JAX package: ``FLConfig.execution="sequential"`` (the
per-cohort reference oracle), ``round_overlap=1`` (the §⑤ depth-2 round
overlap; ``run``/``evaluate`` drain it first), and ``population_store``
(§⑥: per-client soft state in a chunked ``PopulationStore``, streaming
availability, churn through ``apply_churn`` or an attached ``churn``
stream, ``warm_rearrivals``). ``evaluate`` serves every client from its
serving cohort's model, and ``ftfa_eval`` fine-tunes a 1% sample of
clients from their serving models and averages their accuracy (§7.2).
``cohort_shards = S > 1`` places the CohortBank and the round's rows over
an S-shard cohort mesh (§④, ``fl/pipeline.py``); ``round_cursor`` is the
round a resumed driver loop runs next (``checkpoint.save_run``/``load_run``).

The engine runs on ``device`` (default "cuda"; constructing it without a
device on a host without CUDA raises). Under sharding ``devices`` lists
the shards' devices in order (``[torch.device("cuda:0")] * S`` puts S
logical shards on one card); without it the shards take the first S cards,
or all the CPU when ``device="cpu"``; the engine's own device is then shard
0's. ``init_params`` (a dict of numpy arrays) overrides the seeded init, so
that a run can start from the JAX package's exact initial weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.convert import params_from_numpy
from repro_torch.core.coordinator import CohortCoordinator, PartitionEvent
from repro_torch.core.criteria import PartitionCriteria
from repro_torch.core.selection import CohortSelector
from repro_torch.core.sketch import GradientSketcher
from repro_torch.data.availability import AvailabilityTrace, DeviceSpeeds
from repro_torch.data.plane import DataPlane, as_plane
from repro_torch.fl.algorithms import make_server_opt
from repro_torch.fl.client import local_train
from repro_torch.fl.pipeline import RoundPipeline, table_capacity
from repro_torch.launch.mesh import canonical_device
from repro_torch.scale import (
    ClientField,
    DictProbeCache,
    StoreProbeCache,
    StreamingAvailability,
    make_client_store,
)
from repro_torch.utils.tree import tree_map


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
    # "batched" = one fused step per round; "sequential" = per-cohort
    # training launches (the reference oracle)
    execution: str = "batched"
    # §⑤ 0 = synchronous rounds; 1 = depth-2 overlap (round r+1 planned
    # against one-round-stale tables while the card runs round r;
    # partitions flush). Requires execution="batched".
    round_overlap: int = 0
    # cohort-parallel placement (§④): shard the CohortBank's slot axis and
    # the flat row axis over a mesh of this many shards; 0/1 = one device,
    # >1 requires execution="batched"
    cohort_shards: int = 0
    # rows each shard owns in the round; 0 = auto (2·width/S, the balanced
    # share with 2x skew slack). A cohort whose shard block fills trains
    # with fewer participants that round (RoundPipeline.dropped_rows); the
    # full width keeps single-device participant semantics.
    rows_per_shard: int = 0
    # a client id may hold at most ONE kept row per round unless set
    allow_cross_cohort_duplicates: bool = False
    # §⑥ keep per-client soft state in a chunked PopulationStore (memory
    # scales with the touched clients; churn becomes possible); small-N
    # runs are bit-for-bit the dense path
    population_store: bool = False
    # availability under population_store: "compat" = the dense draw,
    # "chunked" = per-chunk Poisson thinning (the million-client mode)
    availability_mode: str = "compat"
    # re-arrivals check in at their probe fingerprint's nearest-identity
    # leaf instead of re-exploring cold (needs population_store)
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


class AuxoEngine:
    def __init__(
        self,
        task,
        population,  # a DataPlane, or a FederatedClassification to wrap
        fl: FLConfig,
        auxo: Optional[AuxoConfig] = None,
        *,
        device=None,
        devices=None,
        init_params: Optional[Dict[str, np.ndarray]] = None,
    ):
        if devices is not None:
            if int(fl.cohort_shards or 0) <= 1:
                raise ValueError("devices= places cohort shards: set FLConfig.cohort_shards > 1")
            devices = [canonical_device(d) for d in devices]
            if device is not None and canonical_device(device) != devices[0]:
                raise ValueError(f"device {device} is not shard 0's device {devices[0]}")
            device = devices[0]
        self.device = resolve_device(device)
        self.devices = devices
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
        # §⑥ population plane: chunked client-state store + streaming
        # availability (compat mode = bit-equal dense draws). Dense mode
        # keeps plain numpy arrays; the facades below index identically.
        if fl.population_store:
            self.store = make_client_store(
                self.data.n_clients, self.auxo.d_sketch, table_capacity(fl, self.auxo)
            )
            self.trace = StreamingAvailability(
                self.data.n_clients, seed=fl.seed, mode=fl.availability_mode
            )
        else:
            self.store = None
            self.trace = AvailabilityTrace(self.data.n_clients, seed=fl.seed)
        self.churn = None  # optional ChurnStream, applied per step()
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
        if self.store is not None:
            self.fingerprint = ClientField(self.store, "fingerprint")
            self.fp_seen = ClientField(self.store, "fp_seen")
            self.neg_streak = ClientField(self.store, "neg_streak")
        else:
            self.fingerprint = np.zeros((self.data.n_clients, self.auxo.d_sketch), np.float32)
            self.fp_seen = np.zeros(self.data.n_clients, bool)
            self.neg_streak = np.zeros(self.data.n_clients, np.int32)
        self.fp_beta = 0.4
        # cross-cohort sketch mean EMA (the global centering reference)
        self.global_mu = np.zeros(self.auxo.d_sketch, np.float32)
        self.global_mu_seen = False
        # serve-time probe fingerprints, cached across evaluate calls and
        # invalidated when the tree partitions
        self._probe_cache = (
            StoreProbeCache(self.store) if self.store is not None else DictProbeCache()
        )
        self._probe_cache_key = -1
        self.probe_train_dispatches = 0  # batched probe trainings run
        # §⑨ the round step() runs next: advanced by step(), saved by
        # checkpoint.save_run and restored by load_run
        self.round_cursor = 0
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

    def client_cluster_index(self, c: int, cohort_id: str) -> int:
        """The client's sub-cluster index L inside `cohort_id` (-1 unknown)."""
        slot = self.pipeline.bank.slot_of.get(cohort_id)
        if slot is None:
            return -1
        return self.pipeline.table.cluster_at(c, slot)

    # ------------------------------------------------------- stage ② rows
    def _train_cohort(self, params, xs, ys, keys):
        """One cohort's local training (the sequential oracle): unstacked
        ``params`` trained on every row of xs (R, steps, batch, ...) ->
        (deltas (R, ...), losses (R,))."""
        fl = self.fl
        rows = {k: v[None].expand((xs.shape[0],) + tuple(v.shape)) for k, v in params.items()}
        return local_train(
            self.task.loss, rows, xs, ys, keys, lr=fl.lr, prox_mu=fl.prox_mu,
            dp_clip=fl.dp_clip, dp_sigma=fl.dp_sigma,
        )

    # ------------------------------------------------------------------ API
    def run(self) -> List[Dict[str, Any]]:
        for r in range(self.fl.rounds):
            self.step(r)
            if r % self.fl.eval_every == 0 or r == self.fl.rounds - 1:
                self.history.append(self.evaluate(r))
        # §⑤: retire any round still in flight so post-run state is final
        self.pipeline.flush()
        return self.history

    def step(self, r: int):
        """One global round: MatchPlan → BatchedExecution → FeedbackBatch."""
        if self.churn is not None:
            departures, arrivals = self.churn.step(r)
            self.apply_churn(departures, arrivals)
        self.pipeline.run_round(r)
        self.round_cursor = r + 1

    # ------------------------------------------------------------ §⑥ churn
    def apply_churn(self, departures=(), arrivals=()):
        """Dynamic population: departures lose ALL server-held soft state
        (affinity records, fingerprint EMA, probe cache: the §5.2
        soft-state-loss semantics) and leave the sampling population;
        arrivals (or re-arrivals) join cold. With round overlap a departure
        can lag one in-flight round, like any staleness of the §⑤ schedule.
        Blacklist entries are identity-level and survive."""
        if self.store is None:
            raise ValueError("churn requires FLConfig.population_store=True")
        departures = np.asarray(departures, np.int64)
        arrivals = np.asarray(arrivals, np.int64)
        # drop cached probe fingerprints FIRST: a re-arrival with the same
        # id must re-probe cold
        self._probe_cache.drop(np.concatenate([departures, arrivals]))
        self.store.depart(departures)
        self.store.arrive(arrivals)
        # churned ids drop their cached data-plane state (sizes, LRU shards)
        self.data.invalidate(np.concatenate([departures, arrivals]))

    def _apply_partition(self, event: PartitionEvent):
        """Warm-start children + seed child rewards (kept for direct use)."""
        self.pipeline._apply_partition(event, self.coordinator.tree.leaves())

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

    def _probe_fingerprint(self, c: int) -> np.ndarray:
        """Single-client view of `_probe_fingerprints` (shares its cache)."""
        return self._probe_fingerprints(np.array([c], np.int64))[0]

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
        # §⑤: retire the in-flight round first (fingerprints, identities and
        # tables must be consistent with the bank models)
        self.pipeline.flush()
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


    # ------------------------------------------------- FTFA personalization
    def ftfa_eval(self, steps: int = 5) -> float:
        """Fine-tune-then-average personalization on top of cohort models.

        Every 1%-th client (``n // 100`` apart) fine-tunes its own serving
        cohort's model, gathered per row from the stacked bank, for
        ``steps`` plain SGD steps (``lr`` only: no prox, no DP) on batches
        drawn from the engine's training ``rng`` (the JAX package's
        stream, draw for draw), all rows in ONE row-stacked ``local_train``.
        For tasks with ``correct_fraction`` one batched call scores every
        row on its group's test set; otherwise a per-row ``accuracy`` loop.
        Returns the mean accuracy.
        """
        self.pipeline.flush()
        cs = np.arange(0, self.data.n_clients, max(1, self.data.n_clients // 100))
        serving = self.serving_cohorts(cs)
        bank = self.pipeline.bank
        slots = torch.as_tensor([bank.slot_of[l] for l in serving], device=self.device)
        prow = tree_map(lambda a: a[slots], bank.params)
        xs, ys = self.data.sample_batches(cs, self.fl.batch_size, steps, self.rng)
        with torch.no_grad():
            deltas, _ = local_train(
                self.task.loss, prow, torch.from_numpy(xs).to(self.device),
                torch.from_numpy(ys).to(self.device), lr=self.fl.lr,
            )
            pf = tree_map(torch.add, prow, deltas)
            groups = self.data.client_groups(cs)
            tx, ty = self.data.eval_batches()
            if hasattr(self.task, "correct_fraction"):
                accs = self.task.correct_fraction(
                    pf, torch.from_numpy(tx[groups]).to(self.device),
                    torch.from_numpy(ty[groups]).to(self.device),
                )
                return float(accs.mean())
            accs = []
            for j in range(cs.size):  # tasks without a batched accuracy
                p = tree_map(lambda a: a[j], pf)
                g = int(groups[j])
                accs.append(self.task.accuracy(p, tx[g], ty[g]))
        return float(np.mean(accs))


def run_fl(task, population, fl: FLConfig, *, device=None, init_params=None) -> List[Dict[str, Any]]:
    """Cohort-agnostic baseline (single global model)."""
    return AuxoEngine(
        task, population, fl, AuxoConfig(enabled=False), device=device, init_params=init_params
    ).run()


def run_auxo(
    task, population, fl: FLConfig, auxo: Optional[AuxoConfig] = None, *,
    device=None, devices=None, init_params=None,
) -> Tuple[AuxoEngine, List[Dict[str, Any]]]:
    eng = AuxoEngine(task, population, fl, auxo or AuxoConfig(), device=device, devices=devices,
                     init_params=init_params)
    hist = eng.run()
    return eng, hist
