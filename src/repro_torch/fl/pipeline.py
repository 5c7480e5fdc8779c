"""The synchronous Auxo round: MatchPlan → BatchedExecution → FeedbackBatch.

Port of the synchronous single-device batched path of
``repro.fl.pipeline``:

  ① MatchPlan        — ε-greedy + sticky-reward + negative-streak matching
                       as numpy masks over dense per-(client, cohort-slot)
                       affinity tables, and ONE fingerprint-vs-leaf-identity
                       cosine-similarity kernel launch;
  ② BatchedExecution — participants of every leaf cohort pack along one
                       flat row axis; each row gathers its cohort's params
                       from the stacked CohortBank, local SGD runs for all
                       rows at once, the masked per-cohort aggregation is
                       ONE segment-sum kernel launch over the flattened
                       deltas (fixed reduction order: the bank is identical
                       run to run, where ``index_add_`` on CUDA reduces with
                       atomics), and the server optimizer updates every slot
                       (``algorithms.apply_stacked``);
  ③ FeedbackBatch    — client fingerprint EMAs update on the host, then
                       ``CohortCoordinator.feedback_all`` clusters all
                       cohorts in one batched pass on the device; rewards,
                       ExploreReward propagation and partition events apply
                       as dense table updates.

Host↔device copies sit where the JAX package has them: the row buffers go
to the device once per round, sketches and losses come back once (stage
③), and the coordinator fetches its assignments and rewards once.

Not in this slice (they raise ``NotImplementedError``): the sequential
oracle (``execution="sequential"``), round overlap, cohort sharding and
the population store.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.cohort import distance_matrix
from repro_torch.fl.algorithms import apply_stacked
from repro_torch.fl.client import local_train
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import map_nested

LATER = "later port slice"


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def bank_capacity(auxo) -> Tuple[int, int]:
    """(bank slot capacity, max leaf count) implied by the partition policy:
    leaves after p splits = 1 + (k-1)p, so the ceiling is
    1 + (k-1)·ceil((max_cohorts-1)/(k-1))."""
    k = max(2, auxo.cluster_k)
    if not auxo.enabled:
        return 1, 1
    n_partitions = -(-(auxo.max_cohorts - 1) // (k - 1))  # ceil
    return 1 + k * n_partitions, 1 + (k - 1) * n_partitions


# ---------------------------------------------------------------------------
# CohortBank: every cohort's params/opt-state stacked on a leading slot axis
# ---------------------------------------------------------------------------
class CohortBank:
    """Stacked parameter storage for all cohort models, fixed capacity.

    Leaves have shape (capacity, ...) on the engine's device; slot 0 is
    the root cohort "0". Partitions copy the parent slot into freshly
    allocated child slots.
    """

    def __init__(self, params, opt_state, capacity: int):
        self.capacity = capacity

        def stack(a):
            out = torch.zeros((capacity,) + tuple(a.shape), dtype=a.dtype, device=a.device)
            out[0] = a
            return out

        self.params = map_nested(stack, params)
        self.opt_state = map_nested(stack, opt_state)
        self.slot_of: Dict[str, int] = {"0": 0}
        self.id_of: Dict[int, str] = {0: "0"}
        self.clock = np.zeros(self.capacity, np.float64)
        self.rounds = np.zeros(self.capacity, np.int64)
        self._next = 1  # number of allocated slots

    def params_of(self, cohort_id: str):
        i = self.slot_of[cohort_id]
        return {k: a[i] for k, a in self.params.items()}

    def opt_state_of(self, cohort_id: str):
        i = self.slot_of[cohort_id]
        return map_nested(lambda a: a[i], self.opt_state)

    def spawn_children(self, parent: str, children: List[str]) -> List[int]:
        """Warm-start child slots from the parent slot (§4.2)."""
        ps = self.slot_of[parent]
        idx = []
        for ch in children:
            if self._next >= self.capacity:
                raise RuntimeError(f"CohortBank capacity {self.capacity} exhausted at {ch}")
            slot = self._next
            self.slot_of[ch] = slot
            self.id_of[slot] = ch
            idx.append(slot)
            self._next += 1

        def copy(a):
            a[idx] = a[ps].clone()  # in-place update of the bank tensor
            return a

        map_nested(copy, self.params)
        map_nested(copy, self.opt_state)
        self.clock[idx] = self.clock[ps]
        self.rounds[idx] = self.rounds[ps]
        return idx


# ---------------------------------------------------------------------------
# Dense client-affinity tables (soft state, vectorized; numpy as in JAX)
# ---------------------------------------------------------------------------
class AffinityTable:
    """Per-(client, cohort-slot) reward records as dense arrays."""

    def __init__(self, n_clients: int, capacity: int):
        self.reward = np.zeros((n_clients, capacity), np.float32)
        self.known = np.zeros((n_clients, capacity), bool)
        self.cluster_idx = np.full((n_clients, capacity), -1, np.int32)

    def wipe(self, cids: np.ndarray):
        """§5.2 unstable clients: lost soft state restarts exploration."""
        self.reward[cids] = 0.0
        self.known[cids] = False
        self.cluster_idx[cids] = -1

    def feedback(self, cids: np.ndarray, slot: int, delta: np.ndarray, gamma: float):
        """EMA reward-record update: R <- γ·ΔR + (1−γ)·R."""
        self.reward[cids, slot] = gamma * delta + (1.0 - gamma) * self.reward[cids, slot]
        self.known[cids, slot] = True

    def set_cluster(self, cids: np.ndarray, slot: int, assign: np.ndarray):
        has = assign >= 0  # -1 = clustering not yet started
        self.cluster_idx[cids[has], slot] = assign[has]

    def propagate(self, cids: np.ndarray, delta: np.ndarray, slot_dist: Dict[int, int]):
        """ExploreReward (§4.3): push ΔR/(d+1) to the other leaves."""
        if not slot_dist or cids.size == 0:
            return
        slots = np.fromiter(slot_dist.keys(), np.int64, len(slot_dist))
        dists = np.fromiter(slot_dist.values(), np.float64, len(slot_dist))
        self.reward[np.ix_(cids, slots)] += delta[:, None] / (dists[None, :] + 1)
        self.known[np.ix_(cids, slots)] = True

    def seed_children(self, parent_slot: int, child_slots: List[int]):
        """Algorithm 1 line 22: child rewards R + 0.1·1(L == k)."""
        has = self.known[:, parent_slot]
        base = self.reward[has, parent_slot]
        L = self.cluster_idx[has, parent_slot]
        for k, cs in enumerate(child_slots):
            self.reward[has, cs] = base + np.where(L == k, 0.1, 0.0)
            self.known[has, cs] = True
            self.cluster_idx[has, cs] = 0

    def preferred_slot(self, c: int, slots: np.ndarray) -> Optional[int]:
        known = self.known[c, slots]
        if not known.any():
            return None
        masked = np.where(known, self.reward[c, slots], -np.inf)
        return int(slots[int(np.argmax(masked))])

    def gather_rows(self, cids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.reward[cids], self.known[cids], self.cluster_idx[cids]

    def scatter_rows(self, cids, reward, known, cluster_idx):
        self.reward[cids] = reward
        self.known[cids] = known
        self.cluster_idx[cids] = cluster_idx

    def match_view(self, cids, slots) -> Tuple[np.ndarray, np.ndarray]:
        return self.reward[cids][:, slots], self.known[cids][:, slots]

    def known_at(self, cids, slot) -> np.ndarray:
        return self.known[cids, slot]

    def cluster_at(self, c, slot) -> int:
        return int(self.cluster_idx[c, slot])


def check_cross_cohort_unique(client_rows: np.ndarray, kept: np.ndarray):
    """Assert no client id occupies two kept rows in one round."""
    ids = client_rows[kept]
    uniq, counts = np.unique(ids, return_counts=True)
    dup = uniq[counts > 1]
    if dup.size:
        raise ValueError(
            f"client id(s) {dup[:8].tolist()} hold kept rows in more than one "
            "cohort this round; set FLConfig.allow_cross_cohort_duplicates=True "
            "to permit multi-cohort membership explicitly"
        )


# ---------------------------------------------------------------------------
# Stage outputs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MatchPlan:
    """Stage-① output: the round's flat, fixed-width execution layout. Rows
    fill leaf by leaf in tree order; the first ``n_real`` rows are real
    participants, the rest padding (the JAX package's canonical order,
    which on one device is the row order itself)."""

    round_idx: int
    leaves: List[str]  # all leaf cohorts, tree order
    active: List[str]  # leaves that train this round (≥ 2 candidates)
    slot_rows: np.ndarray  # (B,) int32 bank slot per flat row
    client_rows: np.ndarray  # (B,) int32 client id per row
    real: np.ndarray  # (B,) bool — row is a real participant (not padding)
    kept: np.ndarray  # (B,) bool — survived the over-commitment straggler drop
    claimed: np.ndarray  # (B,) bool — client requested this cohort as best-fit
    sizes: np.ndarray  # (B,) float32 client dataset sizes
    update_slots: np.ndarray  # (capacity,) bool — slots that train this round
    durations: Dict[str, float]
    key_seed: int
    n_real: int  # real participant rows this round


@dataclasses.dataclass
class ExecResult:
    """Stage-② output, copied to the host once: per-row sketches and losses."""

    sketches: np.ndarray  # (B, d_sketch)
    losses: np.ndarray  # (B,)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------
class RoundPipeline:
    """Drives one synchronous global round on one device."""

    def __init__(self, engine, mode: str = "batched"):
        if mode != "batched":
            raise NotImplementedError(f"execution={mode!r}: {LATER}")
        fl, auxo = engine.fl, engine.auxo
        if int(getattr(fl, "round_overlap", 0) or 0):
            raise NotImplementedError(f"round_overlap: {LATER}")
        if int(fl.cohort_shards or 0) > 1:
            raise NotImplementedError(f"cohort_shards > 1: {LATER}")
        self.eng = engine
        self.mode = mode
        capacity, self.max_leaves = bank_capacity(auxo)
        self.bank = CohortBank(
            engine._init_params, engine.server_opt.init(engine._init_params), capacity
        )
        self.table = AffinityTable(engine.data.n_clients, self.bank.capacity)
        # §⑧ serving snapshot: the newest bank state consistent with the
        # host tables (a round boundary), republished after every round.
        # Each round's step replaces the bank's tensors rather than
        # updating them, so holding the reference is a snapshot.
        self.serve_params = self.bank.params
        self._all_ids_cache: Optional[np.ndarray] = None
        # flat execution width: the full round budget, fixed for the run;
        # L·quota(L) ≤ max(int(P·oc), 2·L) for every leaf count L
        self.width = max(2, int(fl.participants_per_round * fl.overcommit), 2 * self.max_leaves)
        # cumulative host wall-time per stage
        self.stage_seconds = {"plan": 0.0, "pack": 0.0, "dispatch": 0.0, "feedback": 0.0}

    @property
    def _all_ids(self) -> np.ndarray:
        if self._all_ids_cache is None:
            self._all_ids_cache = np.arange(self.eng.data.n_clients, dtype=np.int64)
        return self._all_ids_cache

    def _timed(self, key: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stage_seconds[key] += time.perf_counter() - t0

    # ------------------------------------------------------------ stage ①
    def plan_round(self, r: int) -> Optional[MatchPlan]:
        eng, fl, auxo = self.eng, self.eng.fl, self.eng.auxo
        if fl.use_availability:
            avail = np.asarray(eng.trace.available(r, eng.rng))
        else:
            avail = self._all_ids
        bl = eng.coordinator.blacklist
        if bl:
            avail = avail[~np.isin(avail, np.fromiter(bl, int, len(bl)))]
        if avail.size == 0:
            return None

        leaves = eng.coordinator.tree.leaves()
        slots = np.array([self.bank.slot_of[l] for l in leaves])
        nA = avail.size
        if auxo.enabled and len(leaves) > 1:
            want, claimed = self._match_vectorized(r, avail, leaves, slots)
        else:
            want = np.zeros(nA, np.int64)
            # single-leaf rounds: a client "claims" the only cohort iff it
            # holds any reward record there (§5.2 detection stays live)
            claimed = self.table.known_at(avail, int(slots[0]))

        # per-cohort resource budget: equal split of the round budget (§4.4)
        quota = max(2, int(fl.participants_per_round * fl.overcommit / len(leaves)))
        B = self.width
        slot_rows = np.zeros(B, np.int32)
        client_rows = np.zeros(B, np.int32)
        real = np.zeros(B, bool)
        kept = np.zeros(B, bool)
        claim_rows = np.zeros(B, bool)
        update_slots = np.zeros(self.bank.capacity, bool)
        durations: Dict[str, float] = {}
        active: List[str] = []
        cursor = 0
        for li, leaf in enumerate(leaves):
            cand = avail[want == li]
            if cand.size < 2:
                continue
            ccl = claimed[want == li]
            take = min(quota, cand.size)
            sel = eng.rng.choice(cand.size, size=take, replace=False)
            part = cand[sel]
            # over-commitment straggler drop: latency is a pure function of
            # device speeds, so the kept set is known before execution
            kept_ids, duration = eng.speeds.round_duration(
                part, fl.local_steps * fl.batch_size, overcommit=fl.overcommit
            )
            rows = slice(cursor, cursor + take)
            slot_rows[rows] = slots[li]
            client_rows[rows] = part
            real[rows] = True
            kept[rows] = np.isin(part, kept_ids)
            claim_rows[rows] = ccl[sel]
            update_slots[slots[li]] = True
            durations[leaf] = duration
            active.append(leaf)
            cursor += take
        n_real = cursor
        if n_real == 0:
            return None
        # padding rows replicate the first row (weight 0, never kept)
        slot_rows[n_real:] = slot_rows[0]
        client_rows[n_real:] = client_rows[0]
        if not fl.allow_cross_cohort_duplicates:
            check_cross_cohort_unique(client_rows, kept)
        sizes = eng.data.client_sizes(client_rows).astype(np.float32)
        return MatchPlan(
            round_idx=r, leaves=leaves, active=active, slot_rows=slot_rows,
            client_rows=client_rows, real=real, kept=kept, claimed=claim_rows,
            sizes=sizes, update_slots=update_slots, durations=durations,
            key_seed=int(eng.rng.integers(2**31)), n_real=n_real,
        )

    def _match_vectorized(self, r, avail, leaves, slots):
        """①-matching without a per-client loop. Returns (want — index into
        ``leaves`` per available client, claimed — whether the choice equals
        the client's preferred cohort)."""
        eng, auxo = self.eng, self.eng.auxo
        nA = avail.size
        eps = eng.selector.epsilon(r)
        u = eng.rng.random(nA)
        rand_pick = eng.rng.integers(len(leaves), size=nA)

        rew_blk, known = self.table.match_view(avail, slots)  # (nA, L) each
        rew = np.where(known, rew_blk, -np.inf)
        known_any = known.any(1)
        rand_draw = (~known_any) | (u < eps)

        # persistently-negative clients: forced exploration + optional
        # fingerprint decay
        forced = eng.neg_streak[avail] >= auxo.neg_streak_explore
        if forced.any():
            if auxo.fp_decay_on_streak < 1.0:
                eng.fingerprint[avail[forced]] *= auxo.fp_decay_on_streak
            eng.neg_streak[avail[forced]] = 0

        exploit = np.argmax(rew, axis=1)
        want = np.where(rand_draw | forced, rand_pick, exploit)
        idx = np.arange(nA)
        # a client is EXPLORING only if it holds no reward record for the
        # cohort it picked
        exploring = ~known[idx, want]
        exploring |= forced
        best_r = np.where(known[idx, want], rew[idx, want], 0.0)

        # sticky-reward check (assisted matching): fingerprinted clients
        # whose best reward is below the stick threshold are placed by flat
        # nearest-identity matching — ONE cosine-similarity launch
        thresh = auxo.reward_stick if auxo.assisted_matching else 0.0
        to_root = eng.fp_seen[avail] & (~exploring) & (best_r <= thresh)
        if to_root.any():
            ident_leaves = [l for l in leaves if l in eng.coordinator.identity]
            if len(ident_leaves) >= 2:
                idents = np.stack([eng.coordinator.identity[l] for l in ident_leaves]).astype(np.float32)
                fps = eng.fingerprint[avail[to_root]]
                # no power-of-two padding of the batch (the JAX package pads
                # to avoid recompiles; the CUDA kernel takes any P as is)
                sims = kops.cosine_similarity(
                    torch.from_numpy(np.ascontiguousarray(fps)).to(eng.device),
                    torch.from_numpy(idents).to(eng.device),
                ).cpu().numpy()
                li = np.array([leaves.index(l) for l in ident_leaves])
                want[to_root] = li[np.argmax(sims, axis=1)]
            else:
                # identities not established yet: per-client prototype
                # descent through the tree (rare — first rounds only)
                for j in np.nonzero(to_root)[0]:
                    c = int(avail[j])
                    leaf = eng.coordinator.match_request(
                        c, "0", self.table.cluster_at(c, 0), fingerprint=eng.fingerprint[c]
                    )
                    if leaf in leaves:
                        want[j] = leaves.index(leaf)
        claimed = known_any & (want == exploit)
        return want, claimed

    # ------------------------------------------------------------ stage ②
    def _exec_step(self, slot_rows, xs, ys, seed, sizes, kept, upd):
        """Every leaf cohort's local training, masked aggregation and server
        optimizer over the stacked bank -> (new params, new opt state,
        sketches (B, d_sketch), losses (B,))."""
        eng, fl = self.eng, self.eng.fl
        nseg = self.bank.capacity
        bparams = self.bank.params
        # per-row threefry keys: row i uses split(key(seed), B)[i], the JAX
        # package's stream; only DP noise draws from them
        keys = None
        if fl.dp_clip > 0.0 and fl.dp_sigma > 0.0:
            keys = rnd.split(rnd.key(seed, device=eng.device), self.width)
        prow = {k: a[slot_rows] for k, a in bparams.items()}  # gather
        deltas, losses = local_train(
            eng.task.loss, prow, xs, ys, keys, lr=fl.lr, prox_mu=fl.prox_mu,
            dp_clip=fl.dp_clip, dp_sigma=fl.dp_sigma,
        )
        # masked per-cohort aggregation (q-FedAvg or size weighting)
        wr = torch.pow(torch.clamp(losses, min=1e-6), fl.qfed_q) if fl.qfed_q > 0 else sizes
        wr = wr * kept
        denom = kops.segment_aggregate(wr[:, None], slot_rows, nseg)[:, 0]
        w = wr / torch.clamp(denom[slot_rows], min=1e-9)
        names = sorted(deltas)
        B = slot_rows.shape[0]
        flat = torch.cat([deltas[k].reshape(B, -1) for k in names], dim=1)
        agg_flat = kops.segment_aggregate(flat, slot_rows, nseg, weights=w)  # (nseg, n_params)
        agg, off = {}, 0
        for k in names:
            n = bparams[k][0].numel()
            agg[k] = agg_flat[:, off:off + n].reshape(bparams[k].shape)
            off += n
        new_p, new_o = apply_stacked(eng.server_opt, bparams, self.bank.opt_state, agg, upd)
        sketches = eng.sketcher.batch(deltas)
        return new_p, new_o, sketches, losses

    def _pack_rows(self, plan: MatchPlan):
        """Host-side data plane: local batches for every row as ONE batched
        population draw in the canonical order (padding rows replicate the
        first row's batch with weight 0), then one copy to the device."""
        eng, fl = self.eng, self.eng.fl
        B, n = plan.slot_rows.shape[0], plan.n_real
        cids = plan.client_rows[:n]
        xs_r, ys_r = eng.data.sample_batches(cids, fl.batch_size, fl.local_steps, eng.rng)
        if eng.corrupted:
            bad = np.isin(cids, np.fromiter(eng.corrupted, np.int64, len(eng.corrupted)))
            if bad.any():
                ys_r[bad] = eng.rng.integers(
                    0, eng.data.n_classes, size=ys_r[bad].shape
                ).astype(ys_r.dtype)
        xs = np.empty((B,) + xs_r.shape[1:], xs_r.dtype)
        ys = np.empty((B,) + ys_r.shape[1:], ys_r.dtype)
        xs[:n], ys[:n] = xs_r, ys_r
        xs[n:], ys[n:] = xs_r[0], ys_r[0]
        dev = eng.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        return (
            put(plan.slot_rows.astype(np.int64)),
            put(xs),
            put(ys),
            int(plan.key_seed),
            put(plan.sizes),
            put(plan.kept.astype(np.float32)),
            put(plan.update_slots),
        )

    def execute(self, plan: MatchPlan, packed=None) -> ExecResult:
        """Stage ②: run the round's fused step on the device."""
        eng, fl = self.eng, self.eng.fl
        if packed is None:
            packed = self._timed("pack", self._pack_rows, plan)
        t0 = time.perf_counter()
        with torch.no_grad():
            new_p, new_o, sketches, losses = self._exec_step(*packed)
        self.bank.params = new_p
        self.bank.opt_state = new_o
        res = ExecResult(sketches.cpu().numpy(), losses.cpu().numpy())
        self.stage_seconds["dispatch"] += time.perf_counter() - t0
        # simulated wall-clock + resource accounting
        for leaf in plan.active:
            slot = self.bank.slot_of[leaf]
            self.bank.clock[slot] += plan.durations[leaf]
            self.bank.rounds[slot] += 1
        eng.resource_used += int(plan.real.sum()) * fl.local_steps * fl.batch_size
        return res

    # ------------------------------------------------------------ stage ③
    def apply_feedback(self, plan: MatchPlan, res: ExecResult) -> bool:
        """Retire a round: clustering feedback + dense-table updates.
        Returns True iff a partition event was applied."""
        t0 = time.perf_counter()
        try:
            return self._apply_feedback(plan, res)
        finally:
            self.stage_seconds["feedback"] += time.perf_counter() - t0

    def _apply_feedback(self, plan: MatchPlan, res: ExecResult) -> bool:
        eng, fl, auxo = self.eng, self.eng.fl, self.eng.auxo
        if not auxo.enabled:
            return False
        nact = len(plan.active)
        if nact == 0:
            return False
        rows_by = [
            np.nonzero(plan.kept & (plan.slot_rows == self.bank.slot_of[leaf]))[0]
            for leaf in plan.active
        ]
        # per-cohort batch width: the power-of-two bucket of the round's
        # largest kept set (as the JAX package, so padded shapes agree)
        p_fb = max(8, _next_pow2(max(r.size for r in rows_by)))
        fp_batch = np.zeros((nact, p_fb, auxo.d_sketch), np.float32)
        masks = np.zeros((nact, p_fb), np.float32)
        kept_ids_list: List[np.ndarray] = []
        claimed_list: List[np.ndarray] = []
        for ci, leaf in enumerate(plan.active):
            rows = rows_by[ci]
            kept_ids = plan.client_rows[rows]
            sk_kept = res.sketches[rows]
            # center against the cross-cohort GLOBAL mean (EMA'd in leaf
            # order), normalize, EMA into the client-held fingerprint
            round_mu = sk_kept.mean(0)
            if eng.global_mu_seen:
                eng.global_mu = 0.8 * eng.global_mu + 0.2 * round_mu
            else:
                eng.global_mu, eng.global_mu_seen = round_mu.copy(), True
            ctr = sk_kept - eng.global_mu[None, :]
            ctr /= np.linalg.norm(ctr, axis=1, keepdims=True) + 1e-9
            if fl.affinity_loss_rate > 0:
                lose = eng.rng.random(kept_ids.size) < fl.affinity_loss_rate
                eng.fingerprint[kept_ids[lose]] = 0.0
                eng.fp_seen[kept_ids[lose]] = False
            seen = eng.fp_seen[kept_ids]
            eng.fingerprint[kept_ids] = np.where(
                seen[:, None],
                (1 - eng.fp_beta) * eng.fingerprint[kept_ids] + eng.fp_beta * ctr,
                ctr,
            )
            eng.fp_seen[kept_ids] = True
            fp_batch[ci, : kept_ids.size] = eng.fingerprint[kept_ids]
            masks[ci, : kept_ids.size] = 1.0
            kept_ids_list.append(kept_ids)
            claimed_list.append(plan.claimed[rows])

        results = eng.coordinator.feedback_all(
            plan.active,
            [k.tolist() for k in kept_ids_list],
            torch.from_numpy(fp_batch).to(eng.device),
            torch.from_numpy(masks).to(eng.device),
            plan.round_idx,
            fl.rounds,
            claimed_list,
        )

        # dense-table reward application + ExploreReward propagation; `cur`
        # tracks the live leaf set so propagation targets follow the
        # cohort-by-cohort semantics
        cur = list(plan.leaves)
        dists = distance_matrix(cur)
        gamma = auxo.gamma
        if (
            fl.affinity_loss_rate == 0
            and not fl.allow_cross_cohort_duplicates
            and not any(fb.event is not None for fb in results)
        ):
            self._apply_rewards_vectorized(results, cur, dists, gamma)
            return False
        any_event = False
        for fb in results:
            ids = np.asarray(fb.client_ids, np.int64)
            if ids.size == 0:
                if fb.event is not None:
                    any_event = True
                    self._apply_partition(fb.event, cur)
                continue
            neg = fb.delta < 0
            eng.neg_streak[ids[neg]] += 1
            eng.neg_streak[ids[~neg]] = 0
            if fl.affinity_loss_rate > 0:
                lose = eng.rng.random(ids.size) < fl.affinity_loss_rate
            else:
                lose = np.zeros(ids.size, bool)
            if lose.any():
                self.table.wipe(ids[lose])  # unstable client restarts exploring
            ok = ~lose
            slot = self.bank.slot_of[fb.cohort_id]
            self.table.feedback(ids[ok], slot, fb.delta[ok], gamma)
            self.table.set_cluster(ids[ok], slot, fb.assign[ok])
            src = cur.index(fb.cohort_id)
            slot_dist = {
                self.bank.slot_of[o]: int(dists[src, j])
                for j, o in enumerate(cur)
                if o != fb.cohort_id
            }
            self.table.propagate(ids[ok], fb.delta[ok], slot_dist)
            if fb.event is not None:
                any_event = True
                self._apply_partition(fb.event, cur)
                dists = distance_matrix(cur)
        return any_event

    def _apply_rewards_vectorized(self, results, cur: List[str], dists, gamma):
        """Event-free stage-③ table application as a handful of numpy ops
        (client ids are unique across cohorts within a round)."""
        eng = self.eng
        live = [fb for fb in results if len(fb.client_ids) > 0]
        if not live:
            return
        ids = np.concatenate([np.asarray(fb.client_ids, np.int64) for fb in live])
        delta = np.concatenate([fb.delta for fb in live]).astype(np.float32)
        assign = np.concatenate([fb.assign for fb in live])
        src = np.concatenate(
            [np.full(len(fb.client_ids), cur.index(fb.cohort_id), np.int64) for fb in live]
        )
        neg = delta < 0
        eng.neg_streak[ids[neg]] += 1
        eng.neg_streak[ids[~neg]] = 0
        leaf_slots = np.array([self.bank.slot_of[l] for l in cur], np.int64)
        own = leaf_slots[src]
        row = np.arange(ids.size)
        rw, kn, cl = self.table.gather_rows(ids)
        # EMA reward-record update on the trained cohort's slot
        rw[row, own] = gamma * delta + (1.0 - gamma) * rw[row, own]
        has = assign >= 0
        cl[row[has], own[has]] = assign[has]
        # ExploreReward propagation: ΔR/(d+1) to every OTHER leaf
        w = delta[:, None] / (dists[src] + 1.0)
        w[row, src] = 0.0
        rw[:, leaf_slots] += w.astype(np.float32)
        kn[:, leaf_slots] = True
        self.table.scatter_rows(ids, rw, kn, cl)

    def _apply_partition(self, event, cur: List[str]):
        child_slots = self.bank.spawn_children(event.parent, event.children)
        self.table.seed_children(self.bank.slot_of[event.parent], child_slots)
        i = cur.index(event.parent)
        cur[i: i + 1] = list(event.children)

    # ------------------------------------------------------------ driver
    def run_round(self, r: int):
        plan = self._timed("plan", self.plan_round, r)
        if plan is None:
            return
        self.apply_feedback(plan, self.execute(plan))
        self.serve_params = self.bank.params
