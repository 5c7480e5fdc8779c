"""Cohort tree, affinity messages, and client-side soft state (paper §3.1, §5.1).

Cohorts form a hierarchy: partitioning cohort "0" into K children creates
"0.0" … "0.K-1"; only *leaf* cohorts run FL training. The tree distance
between cohorts (hops to the lowest common ancestor) drives the
hierarchical ExploreReward propagation of §4.3 (Figure 7).

Affinity messages — (reward R, cluster index L) — are the only state a
client holds; the server is soft-state and can be reconstructed from the
requests clients submit (§5.1).

Copy of ``repro.core.cohort`` (pure Python; the port never imports the
JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class AffinityMessage:
    """Feedback from a cohort to one participant after a round (§5.1)."""

    cohort_id: str
    reward: float  # how well the client fits this cohort
    cluster_index: int  # sub-cluster membership inside this cohort


def tree_distance(a: str, b: str) -> int:
    """Hops from a and b up to their lowest common ancestor, summed.

    Cohort ids are dot-paths ("0.1.0"). Example (Fig. 7): d("0.0.1", "0.0.0")
    = 2, d("0.0.1", "0.1") = 3.
    """
    pa, pb = a.split("."), b.split(".")
    common = 0
    for x, y in zip(pa, pb):
        if x != y:
            break
        common += 1
    return (len(pa) - common) + (len(pb) - common)


def distance_matrix(ids: List[str]):
    """Pairwise tree_distance over a list of cohort ids -> (n, n) int array.

    Used by the vectorized ExploreReward propagation: reward spill to every
    other leaf is delta / (distance + 1), computed for all leaves at once.
    """
    import numpy as np

    n = len(ids)
    out = np.zeros((n, n), np.int32)
    for i in range(n):
        for j in range(i + 1, n):
            d = tree_distance(ids[i], ids[j])
            out[i, j] = out[j, i] = d
    return out


@dataclasses.dataclass
class CohortNode:
    cohort_id: str
    parent: Optional[str]
    children: List[str] = dataclasses.field(default_factory=list)
    alive: bool = True  # cohorts keep training after partition? no — leafs only

    @property
    def is_leaf(self) -> bool:
        return not self.children


class CohortTree:
    """The coordinator's view of all cohorts ever created."""

    def __init__(self, root: str = "0"):
        self.root = root
        self.nodes: Dict[str, CohortNode] = {root: CohortNode(root, None)}

    def leaves(self) -> List[str]:
        return [cid for cid, n in self.nodes.items() if n.is_leaf]

    def partition(self, cohort_id: str, k: int) -> List[str]:
        """Split a leaf cohort into k children; returns the child ids."""
        node = self.nodes[cohort_id]
        assert node.is_leaf, f"{cohort_id} already partitioned"
        children = [f"{cohort_id}.{i}" for i in range(k)]
        for c in children:
            self.nodes[c] = CohortNode(c, cohort_id)
        node.children = children
        return children

    def closest_leaf(self, cohort_id: str, cluster_index: int = 0) -> str:
        """Resolve a (possibly stale, non-leaf) requested cohort to a leaf.

        §5.1 Request Match: clients unaware of a partition may request an
        internal node; descend using their cluster index L, then by first
        child. Unknown ids fall back to the root.
        """
        if cohort_id not in self.nodes:
            cohort_id = self.root
        node = self.nodes[cohort_id]
        while not node.is_leaf:
            idx = cluster_index if 0 <= cluster_index < len(node.children) else 0
            node = self.nodes[node.children[idx]]
            cluster_index = 0  # L is meaningful only for the first hop
        return node.cohort_id

    def depth(self, cohort_id: str) -> int:
        return cohort_id.count(".")

    def __contains__(self, cohort_id: str) -> bool:
        return cohort_id in self.nodes

    def __len__(self) -> int:
        return len(self.nodes)


@dataclasses.dataclass
class ClientAffinity:
    """Client-side soft state: reward + cluster index per explored cohort.

    Lives on the (simulated) device; losing it merely restarts exploration
    (§5.2 unstable clients).
    """

    rewards: Dict[str, float] = dataclasses.field(default_factory=dict)
    cluster_index: Dict[str, int] = dataclasses.field(default_factory=dict)

    def update_from_feedback(self, msg: AffinityMessage, gamma: float = 0.2):
        prev = self.rewards.get(msg.cohort_id, 0.0)
        self.rewards[msg.cohort_id] = gamma * msg.reward + (1 - gamma) * prev
        if msg.cluster_index >= 0:  # -1 = clustering not yet started
            self.cluster_index[msg.cohort_id] = msg.cluster_index

    def propagate_explore(self, cohort_id: str, delta: float, known: List[str]):
        """ExploreReward (§4.3): push delta/(d+1) to other cohorts."""
        for other in known:
            if other == cohort_id:
                continue
            d = tree_distance(cohort_id, other)
            self.rewards[other] = self.rewards.get(other, 0.0) + delta / (d + 1)

    def preferred(self) -> Optional[str]:
        if not self.rewards:
            return None
        return max(self.rewards.items(), key=lambda kv: kv[1])[0]

    def wipe(self):
        self.rewards.clear()
        self.cluster_index.clear()
