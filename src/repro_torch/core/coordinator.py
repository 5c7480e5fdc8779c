"""Cohort coordinator (paper §3.2, §5): matching, partition, resilience.

Port of ``repro.core.coordinator``: per round it matches client affinity
requests to leaf cohorts, runs the clustering feedback of every leaf
cohort (``feedback_all``: one batched pass on the device, per-cohort calls
for the sequential oracle, or numpy twins on the host for the overlapped
round; ``feedback``: one cohort), evaluates the Lemma-4.1 partition
criteria, spawns child cohorts and blacklists repeat affinity-claim
offenders. Its soft state checkpoints to a pickle of Python and numpy
objects only (``checkpoint``/``recover``), which either package reads, and
can be rebuilt from the requests clients submit (``rebuild_from_requests``).
"""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.core.clustering import (
    ClusterState,
    OnlineClustering,
    assign_and_update_batched,
    assign_and_update_np,
    host_array,
    host_state,
    kmeans_bootstrap_batched,
    stack_states,
    unstack_states,
)
from repro_torch.core.cohort import AffinityMessage, CohortNode, CohortTree
from repro_torch.core.criteria import PartitionCriteria
from repro_torch.core.selection import instant_reward, instant_reward_batched, instant_reward_np


def _population_heterogeneity_np(sk: np.ndarray, m: np.ndarray) -> float:
    """Numpy twin of clustering.population_heterogeneity for the host-side
    per-cohort stats loop."""
    tot = max(float(m.sum()), 1.0)
    mu = (sk * m[:, None]).sum(0) / tot
    return float((m * ((sk - mu) ** 2).sum(-1)).sum() / tot)


@dataclasses.dataclass
class PartitionEvent:
    parent: str
    children: List[str]
    round_idx: int
    # cluster index -> child id (clients map their L to the new cohort)
    cluster_to_child: Dict[int, str]


@dataclasses.dataclass
class CohortRoundFeedback:
    """Per-cohort output of feedback_all: array-form affinity feedback."""

    cohort_id: str
    client_ids: List[int]
    delta: np.ndarray  # (n,) instant rewards for the valid participants
    assign: np.ndarray  # (n,) cluster indices (-1 before clustering starts)
    event: Optional[PartitionEvent]


@dataclasses.dataclass
class CohortStats:
    initial_participants: float = 0.0
    initial_heterogeneity: float = 1.0
    rounds_trained: int = 0


class CohortCoordinator:
    """Logically-centralized coordinator over the cohort tree."""

    def __init__(
        self,
        d_sketch: int,
        criteria: Optional[PartitionCriteria] = None,
        cluster_k: int = 2,
        clustering_start_frac: float = 0.05,
        anomaly_threshold: float = -0.5,
        anomaly_strikes: int = 3,
        max_cohorts: int = 8,
        seed: int = 0,
        device=None,
    ):
        self.d_sketch = d_sketch
        self.criteria = criteria or PartitionCriteria(k=cluster_k)
        self.cluster_k = cluster_k
        self.clustering_start_frac = clustering_start_frac
        self.anomaly_threshold = anomaly_threshold
        self.anomaly_strikes = anomaly_strikes
        self.max_cohorts = max_cohorts
        self.seed = seed
        self.device = resolve_device(device)

        self.tree = CohortTree()
        self.clusterers: Dict[str, OnlineClustering] = {
            "0": OnlineClustering(cluster_k, d_sketch, seed=seed, device=self.device)
        }
        # per-leaf identity vector: EMA of the member fingerprint mean, for
        # flat nearest-identity matching
        self.identity: Dict[str, np.ndarray] = {}
        self.stats: Dict[str, CohortStats] = {"0": CohortStats()}
        self.strikes: Dict[int, int] = {}
        self.blacklist: set = set()
        self.partitions: List[PartitionEvent] = []
        self.host_states = False  # clusterer states held as numpy leaves

    def use_host_states(self):
        """Hold every clusterer's state as numpy leaves from now on, new
        children's too (the overlapped round's host control plane): reading
        a device state in stage ③ would wait on the round in flight."""
        self.host_states = True
        for cl in self.clusterers.values():
            cl.state = host_state(cl.state)

    # ---------------------------------------------------------------- match
    def match_request(
        self,
        client_id: int,
        requested: Optional[str],
        cluster_index: int = -1,
        fingerprint=None,
    ) -> Optional[str]:
        """§5.1 Request Match: resolve a client's affinity request to a leaf
        by descending the tree (cluster index L at the requested node, then
        fingerprint-vs-prototype cosine, then a deterministic spread)."""
        if client_id in self.blacklist:
            return None
        if requested is None or requested not in self.tree.nodes:
            requested = self.tree.root
        if fingerprint is not None and requested == self.tree.root:
            leaf, _conf = self.match_with_confidence(fingerprint)
            if leaf is not None:
                return leaf
        node = self.tree.nodes[requested]
        first = True
        while not node.is_leaf:
            idx = None
            if first and 0 <= cluster_index < len(node.children):
                idx = cluster_index
            elif fingerprint is not None:
                cl = self.clusterers.get(node.cohort_id)
                if cl is not None and bool(cl.state.initialized):
                    cents = host_array(cl.state.centroids)
                    sims = cents @ np.asarray(fingerprint, np.float32)
                    idx = int(np.argmax(sims[: len(node.children)]))
            if idx is None:
                idx = client_id % len(node.children)
            node = self.tree.nodes[node.children[idx]]
            first = False
        return node.cohort_id

    def match_with_confidence(self, fingerprint):
        """Flat nearest-identity match -> (leaf, margin between the best and
        second-best identity cosine)."""
        leaves = [l for l in self.tree.leaves() if l in self.identity]
        if len(leaves) < 2:
            return None, 0.0
        fp = np.asarray(fingerprint, np.float32)
        nf = np.linalg.norm(fp) + 1e-9
        sims = []
        for l in leaves:
            ident = self.identity[l]
            ni = np.linalg.norm(ident) + 1e-9
            sims.append((float(ident @ fp) / (ni * nf), l))
        sims.sort(reverse=True)
        margin = sims[0][0] - sims[1][0]
        return sims[0][1], margin

    def match_many(self, fingerprints: np.ndarray):
        """Vectorized ``match_with_confidence`` over an (N, d) batch ->
        (best_idx (N,), margin (N,), leaves); empty when fewer than 2
        leaves hold identities."""
        leaves = [l for l in self.tree.leaves() if l in self.identity]
        n = int(np.asarray(fingerprints).shape[0])
        if len(leaves) < 2:
            return np.zeros(n, np.int64), np.zeros(n, np.float32), []
        idents = np.stack([self.identity[l] for l in leaves]).astype(np.float32)
        idn = idents / (np.linalg.norm(idents, axis=1, keepdims=True) + 1e-9)
        fp = np.asarray(fingerprints, np.float32)
        fpn = fp / (np.linalg.norm(fp, axis=1, keepdims=True) + 1e-9)
        sims = fpn @ idn.T  # (N, L)
        order = np.argsort(sims, axis=1)
        best = order[:, -1]
        rows = np.arange(n)
        margin = (sims[rows, best] - sims[rows, order[:, -2]]).astype(np.float32)
        return best.astype(np.int64), margin, leaves

    # ------------------------------------------------------------- feedback
    def feedback(
        self,
        cohort_id: str,
        client_ids: Sequence[int],
        sketches,
        round_idx: int,
        total_rounds: int,
        claimed_preferred: Optional[Sequence[bool]] = None,
        mask=None,
    ) -> Tuple[Dict[int, AffinityMessage], Optional[PartitionEvent]]:
        """One cohort's post-round clustering + reward feedback (§3.2 stage 4).

        sketches: (P, d), a tensor or a numpy array, may be padded to a fixed
        batch size; the first len(client_ids) rows are the valid
        participants and ``mask`` (P,) their validity weights.
        claimed_preferred[i]: client i requested this cohort as its best fit
        (the §5.2 fake-affinity anomaly check). This is ``feedback_all`` on a
        one-cohort stack: the device backend (the cosine and segment kernels
        on the card) with device states, the host backend under
        ``use_host_states()``.
        """
        n = len(client_ids)
        if n == 0:
            return {}, None
        if self.host_states:
            sk = (
                sketches.float().cpu().numpy() if isinstance(sketches, torch.Tensor)
                else np.asarray(sketches, np.float32)
            )
            m = np.ones(sk.shape[0], np.float32) if mask is None else np.asarray(
                mask.cpu() if isinstance(mask, torch.Tensor) else mask, np.float32
            )
            backend = "host"
        else:
            sk = torch.as_tensor(sketches).to(self.device)
            m = (
                torch.ones(sk.shape[0], device=self.device) if mask is None
                else torch.as_tensor(mask).to(self.device).float()
            )
            backend = "device"
        claimed = None if claimed_preferred is None else [list(claimed_preferred)]
        fb = self.feedback_all(
            [cohort_id], [list(client_ids)], sk[None], m[None], round_idx, total_rounds,
            claimed, batched=False, backend=backend,
        )[0]
        messages = {
            cid: AffinityMessage(
                cohort_id=cohort_id, reward=float(fb.delta[i]), cluster_index=int(fb.assign[i])
            )
            for i, cid in enumerate(fb.client_ids)
        }
        return messages, fb.event

    def feedback_all(
        self,
        cohort_ids: Sequence[str],
        client_ids_list: Sequence[Sequence[int]],
        sketches,
        masks,
        round_idx: int,
        total_rounds: int,
        claimed_list: Optional[Sequence[Sequence[bool]]] = None,
        batched: bool = True,
        backend: str = "device",
    ) -> List[CohortRoundFeedback]:
        """Batched ④-feedback for ALL leaf cohorts of a round (§3.2 stage 4).

        sketches: (C, P, d) stacked per-cohort fingerprint batches, masks:
        (C, P); row i of cohort c is client_ids_list[c][i]. Partition
        criteria are evaluated in cohort order with events applied
        immediately.

        backend="device" takes device tensors: the assignment + EMA refresh
        of every initialized cohort and the instant rewards run as one
        batched pass (one kernel launch per primitive for all cohorts), or
        as per-cohort calls with ``batched=False`` (the sequential oracle).
        backend="host" (the §⑤ overlapped round) takes numpy arrays and runs
        the steady-state clustering and rewards as numpy twins, states kept
        as numpy leaves: a launch here would queue behind the in-flight
        round step. In both backends the once-per-cohort-lifetime k-means
        bootstrap runs on the device (rare, and worth the kernel).
        """
        C = len(cohort_ids)
        results: List[CohortRoundFeedback] = []
        if C == 0:
            return results
        host = backend == "host"
        frac = round_idx / max(total_rounds, 1)
        cluster_on = frac >= self.clustering_start_frac
        P = int(sketches.shape[1])
        # one host copy for the per-cohort numpy paths (identity refresh,
        # heterogeneity stats)
        if host:
            sk_host = np.asarray(sketches, np.float32)
            mask_host = np.asarray(masks, np.float32)
        else:
            sk_host = sketches.float().cpu().numpy()
            mask_host = masks.float().cpu().numpy()
        n_by = [len(ids) for ids in client_ids_list]

        assigns = np.full((C, P), -1, np.int32)
        if cluster_on:
            init_idx = [
                i for i, cid in enumerate(cohort_ids)
                if n_by[i] > 0 and not bool(self.clusterers[cid].state.initialized)
            ]
            ready_idx = [i for i in range(C) if n_by[i] > 0 and i not in set(init_idx)]
            if init_idx and host:  # the bootstrap's inputs, on the device
                sketches = torch.from_numpy(sk_host).to(self.device)
                masks = torch.from_numpy(mask_host).to(self.device)
            # once-per-cohort-lifetime k-means bootstrap: one batched run
            # for all cohorts bootstrapping this round; each cohort's own
            # key stream is consumed exactly like a solo `step` call
            if batched and len(init_idx) > 1:
                subs = []
                for i in init_idx:
                    cl = self.clusterers[cohort_ids[i]]
                    cl._key, sub = rnd.split(cl._key)
                    subs.append(sub)
                sel = torch.as_tensor(init_idx, device=sketches.device)
                cents, a_init = kmeans_bootstrap_batched(
                    torch.stack(subs), sketches[sel], masks[sel].float(), self.cluster_k
                )
                a_init = a_init.cpu().numpy()
                for j, i in enumerate(init_idx):
                    cl = self.clusterers[cohort_ids[i]]
                    cl.state = dataclasses.replace(
                        cl.state,
                        centroids=cents[j],
                        initialized=torch.ones((), dtype=torch.bool, device=self.device),
                        round=cl.state.round + 1,
                    )
                    assigns[i] = a_init[j]
            else:
                for i in init_idx:
                    a, _ = self.clusterers[cohort_ids[i]].step(sketches[i], masks[i])
                    assigns[i] = a
            if host:
                for i in init_idx:
                    cl = self.clusterers[cohort_ids[i]]
                    cl.state = host_state(cl.state)
            # every initialized cohort: numpy twins on the host backend,
            # one batched pass, or per-cohort calls
            if ready_idx and host:
                ema = self.clusterers[cohort_ids[ready_idx[0]]].ema
                for i in ready_idx:
                    cl = self.clusterers[cohort_ids[i]]
                    cl.state, a, _sims = assign_and_update_np(cl.state, sk_host[i], mask_host[i], ema)
                    assigns[i] = a
            elif ready_idx and batched:
                stacked = stack_states([self.clusterers[cohort_ids[i]].state for i in ready_idx])
                sel = torch.as_tensor(ready_idx, device=sketches.device)
                ema = self.clusterers[cohort_ids[ready_idx[0]]].ema
                new_states, a, _sims = assign_and_update_batched(
                    stacked, sketches[sel], masks[sel], ema
                )
                a = a.cpu().numpy()
                states = unstack_states(new_states, len(ready_idx))
                for j, i in enumerate(ready_idx):
                    self.clusterers[cohort_ids[i]].state = states[j]
                    assigns[i] = a[j]
            elif ready_idx:
                for i in ready_idx:
                    a, _ = self.clusterers[cohort_ids[i]].step(sketches[i], masks[i])
                    assigns[i] = a

        # instant rewards for all cohorts: numpy twins on the host backend,
        # one batched pass, or per-cohort calls
        if host:
            deltas = np.stack([instant_reward_np(sk_host[i], mask_host[i])[0] for i in range(C)])
        elif batched:
            deltas = instant_reward_batched(sketches, masks)[0].cpu().numpy()
        else:
            deltas = np.stack(
                [instant_reward(sketches[i], masks[i])[0].cpu().numpy() for i in range(C)]
            )

        for i, cid in enumerate(cohort_ids):
            ids = list(client_ids_list[i])
            n = len(ids)
            if n == 0:
                results.append(
                    CohortRoundFeedback(cid, ids, np.zeros(0, np.float32), np.zeros(0, np.int32), None)
                )
                continue
            st = self.stats[cid]
            st.rounds_trained += 1
            st.initial_participants = max(st.initial_participants, float(n))
            if cluster_on and st.rounds_trained <= 3:
                st.initial_heterogeneity = float(
                    _population_heterogeneity_np(sk_host[i], mask_host[i])
                )

            # refresh this leaf's identity vector from member fingerprints
            ident = sk_host[i, :n].mean(0)
            if cid in self.identity:
                self.identity[cid] = 0.8 * self.identity[cid] + 0.2 * ident
            else:
                self.identity[cid] = ident

            # §5.2 fake-affinity anomaly detection
            if claimed_list is not None:
                claimed = np.asarray(claimed_list[i], bool)
                for j in np.nonzero(claimed)[0]:
                    cl = ids[int(j)]
                    if deltas[i, j] < self.anomaly_threshold:
                        self.strikes[cl] = self.strikes.get(cl, 0) + 1
                        if self.strikes[cl] >= self.anomaly_strikes:
                            self.blacklist.add(cl)
                    else:
                        self.strikes[cl] = max(0, self.strikes.get(cl, 0) - 1)

            event = self._maybe_partition(cid, round_idx, total_rounds, n)
            results.append(
                CohortRoundFeedback(cid, ids, deltas[i, :n].copy(), assigns[i, :n].copy(), event)
            )
        return results

    # ------------------------------------------------------------ partition
    def _maybe_partition(
        self, cohort_id: str, round_idx: int, total_rounds: int, participants: int
    ) -> Optional[PartitionEvent]:
        if len(self.tree.leaves()) >= self.max_cohorts:
            return None
        if not self.tree.nodes[cohort_id].is_leaf:
            return None
        clusterer = self.clusterers[cohort_id]
        st = self.stats[cohort_id]
        sizes = clusterer.cluster_sizes()
        ok = self.criteria.should_partition(
            round_idx=round_idx,
            total_rounds=total_rounds,
            parent_dispersion=clusterer.dispersion,
            child_dispersions=list(clusterer.cluster_dispersions()),
            child_sizes=list(sizes),
            participants_per_round=float(participants),
            initial_participants=st.initial_participants,
            initial_heterogeneity=st.initial_heterogeneity,
            clustering_rounds=clusterer.rounds,
            margin=clusterer.margin,
        )
        if not ok:
            return None
        children = self.tree.partition(cohort_id, self.cluster_k)
        parent_cents = host_array(clusterer.state.centroids)
        for i, ch in enumerate(children):
            # hash() of a str is randomized per process: comparisons with
            # the JAX package run in one process
            self._new_clusterer(ch, seed=self.seed + hash(ch) % 10_000)
            # child identity starts as the parent's cluster prototype
            self.identity[ch] = parent_cents[i].copy()
            self.stats[ch] = CohortStats(
                initial_participants=st.initial_participants / self.cluster_k,
                initial_heterogeneity=float(clusterer.cluster_dispersions()[i]),
            )
        event = PartitionEvent(
            parent=cohort_id,
            children=children,
            round_idx=round_idx,
            cluster_to_child={i: ch for i, ch in enumerate(children)},
        )
        self.partitions.append(event)
        return event

    def _new_clusterer(self, cohort_id: str, seed: int = 0):
        """A fresh clusterer for ``cohort_id`` on the coordinator's device
        (numpy leaves under ``use_host_states``)."""
        self.clusterers[cohort_id] = OnlineClustering(
            self.cluster_k, self.d_sketch, seed=seed, device=self.device
        )
        if self.host_states:
            self.clusterers[cohort_id].state = host_state(
                ClusterState.create(self.cluster_k, self.d_sketch, "cpu")
            )

    # ------------------------------------------------------------ tolerance
    def checkpoint(self, path: str | Path):
        """Pickle the soft state as Python and numpy objects only: the tree,
        every clusterer state flattened in ClusterState's field order (the
        JAX package's order, the same 8 fields), the blacklist and the
        partition history. Either package's ``recover`` reads it."""
        state = {
            "tree_nodes": {
                cid: (n.parent, list(n.children)) for cid, n in self.tree.nodes.items()
            },
            "clusterer_states": {
                cid: np.asarray(
                    np.concatenate(
                        [np.ravel(host_array(getattr(c.state, f.name)))
                         for f in dataclasses.fields(c.state)]
                    )
                )
                for cid, c in self.clusterers.items()
            },
            "cluster_k": self.cluster_k,
            "d_sketch": self.d_sketch,
            "blacklist": sorted(self.blacklist),
            "partitions": [dataclasses.asdict(p) for p in self.partitions],
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    @staticmethod
    def recover(path: str | Path, device=None, **kwargs) -> "CohortCoordinator":
        """Cohort-coordinator failover (§5.2): rebuild from checkpoint on
        ``device``.

        Clusterer EMA states restart fresh (seed 0, as the JAX package's
        default; they re-anchor within a few rounds); the tree and the
        blacklist are restored — the information clients cannot replay.
        """
        with open(path, "rb") as f:
            state = pickle.load(f)
        co = CohortCoordinator(
            state["d_sketch"], cluster_k=state["cluster_k"], device=device, **kwargs
        )
        for cid, (parent, children) in sorted(state["tree_nodes"].items(), key=lambda kv: len(kv[0])):
            if cid == "0":
                continue
            if cid not in co.tree.nodes:
                co.tree.nodes[cid] = CohortNode(cid, parent)
                co._new_clusterer(cid)
                co.stats[cid] = CohortStats()
        for cid, (parent, children) in state["tree_nodes"].items():
            co.tree.nodes[cid].children = list(children)
        co.blacklist = set(state["blacklist"])
        return co

    def rebuild_from_requests(self, requests: Sequence[Tuple[int, str, int]]):
        """§5.1 soft-state recovery: reconstruct leaf set from the affinity
        requests clients submit (client_id, cohort_id, cluster_index)."""
        for _cid, cohort_id, _L in requests:
            parts = cohort_id.split(".")
            for depth in range(1, len(parts) + 1):
                node_id = ".".join(parts[:depth])
                if node_id not in self.tree.nodes:
                    parent = ".".join(parts[: depth - 1]) or None
                    self.tree.nodes[node_id] = CohortNode(node_id, parent)
                    if parent and node_id not in self.tree.nodes[parent].children:
                        self.tree.nodes[parent].children.append(node_id)
                    self._new_clusterer(node_id)
                    self.stats[node_id] = CohortStats()
