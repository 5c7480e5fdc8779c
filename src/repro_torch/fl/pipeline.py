"""The Auxo round: MatchPlan → BatchedExecution → FeedbackBatch.

Port of the single-device paths of ``repro.fl.pipeline``:

  ① MatchPlan        — ε-greedy + sticky-reward + negative-streak matching
                       as numpy masks over per-(client, cohort-slot)
                       affinity tables (dense, or a view over the engine's
                       chunked PopulationStore), and ONE fingerprint-vs-
                       leaf-identity cosine-similarity kernel launch;
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
                       cohorts in one batched pass; rewards, ExploreReward
                       propagation and partition events apply as table
                       updates.

``mode="sequential"`` is the REFERENCE ORACLE: the same plan and feedback,
but one padded training launch per cohort, a ``tensordot`` aggregation
(outside any kernel, as in the JAX package) and an eager server-optimizer
update of the cohort's slot.

ROUND PIPELINING (§⑤, ``FLConfig.round_overlap = 1``): a depth-2 software
pipeline. Every round executes a plan computed before the previous round's
feedback landed (one-round staleness). CUDA launches are asynchronous, so
while the card executes round r the host retires round r-1's feedback and
plans, packs and stages round r+1; stage-①/③ control math runs as numpy
twins (``host_control``) because anything that waits on the card there
would serialize the pipeline. Round r's sketches and losses come back by an
asynchronous copy into pinned host buffers, read after its event (the one
wait per round); round r+1's buffers go up by asynchronous copies from
pinned memory. Partition events FLUSH the pipeline (drain the stale round
synchronously, discard the staged plan). ``round_overlap = 0`` keeps the
strict plan → execute → feedback order.

PLACEMENT (§④, ``FLConfig.cohort_shards = S > 1``): the CohortBank's slot
axis splits into S blocks of ``slots_per_shard`` over a cohort mesh
(``launch/mesh.py``), and the flat row axis into S blocks of
``shard_width`` rows, block j packed only with participants of cohorts
whose slots live in shard j. The round then needs no collective: each
device gathers, trains, segment-sums and server-steps only its own slots;
only sketches and losses come back to the host for stage ③. The shards
that share a device form one group (``launch/sharding.shard_groups``),
held as ONE stacked tensor per bank leaf there: the group's step runs all
its row blocks as one batch, and each sum is one kernel launch with a
leading shard axis and block-local slot ids, so S logical shards on one
card cost what one shard does in launches. Groups on different cards run
one after another from the host, each on its card's current stream, so
the cards work at the same time. Row keys follow the plan's canonical
order (``inv``) and each segment sums its rows in row order wherever its
block sits, so with the full row width a sharded run is bit-equal to the
single-device run: always with the plain versions, and on the card while
the denominators are integer client sizes (the segment kernel's D = 1
path groups q-FedAvg's real weights by lane position).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.clustering import _cosine_np
from repro_torch.core.cohort import distance_matrix
from repro_torch.fl.algorithms import apply_stacked
from repro_torch.fl.client import local_train
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import cohort_size, make_cohort_mesh
from repro_torch.launch.sharding import (
    Placed,
    ShardGroup,
    bank_placement,
    bank_shardings,
    padded_capacity,
    place,
    row_placement,
    shard_groups,
)
from repro_torch.scale.store import ChunkedAffinityTable
from repro_torch.utils.tree import leaves, tree_map


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


def table_capacity(fl, auxo) -> int:
    """Affinity-table column count: the bank capacity AFTER shard padding."""
    return padded_capacity(bank_capacity(auxo)[0], max(1, int(fl.cohort_shards or 1)))


def _on(device):
    """Make ``device`` the current CUDA device (its current stream takes the
    launches); nothing to do for the CPU."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _set_rows(a: torch.Tensor, rows, v) -> torch.Tensor:
    """A copy of ``a`` with ``a[rows] = v``. Bank updates outside the fused
    step are out of place: a snapshot holding the old tensors (the serving
    snapshot, a round in flight) stays as it was."""
    out = a.clone()
    out[rows] = v
    return out


# ---------------------------------------------------------------------------
# CohortBank: every cohort's params/opt-state stacked on a leading slot axis
# ---------------------------------------------------------------------------
class CohortBank:
    """Stacked parameter storage for all cohort models, fixed capacity.

    Slot 0 is the root cohort "0". Partitions copy the parent slot into
    freshly allocated child slots. Every update replaces the bank's tensors
    rather than writing into them, so holding them is a snapshot.

    PLACEMENT: with a cohort mesh the capacity is padded to a multiple of
    the shard count and shard j owns the slot block
    ``[j*slots_per_shard, (j+1)*slots_per_shard)``. The shards of one device
    form a group, whose blocks live stacked in one tensor per leaf there
    (``group_params[g]``, ``group_opt[g]``; slot s sits in group
    ``group_of[s]`` at row ``local_of[s]``). Allocation is round-robin over
    the shards (allocation n -> slot (n % S)*slots_per_shard + n//S), so
    live cohorts spread evenly as the tree partitions. ``spawn_children``
    copies the parent slot once to each group that receives a child: the
    only time model bytes move between devices. Without a mesh the bank is
    one group holding every slot on the params' device.

    ``policy`` places a slot's leaves within its shard, as in the reference
    (``launch/sharding.bank_spec``): ``dp`` keeps them whole; ``tp`` on a
    mesh with a model axis (``make_cohort_mesh(n, model=m)``, m > 1) holds
    each leaf as one piece per group and model position, on that
    position's device (``placed_params``, ``placed_opt``: trees of
    ``Placed``; ``group_params`` and ``group_opt`` are then None), split
    along the dim the spec gives ``model`` or whole where it replicates.
    Yogi's m and v follow their parameter's spec. A spawn copies each piece
    to the same position's pieces: model bytes never cross model
    positions. ``fsdp`` names a data axis, which a cohort mesh lacks, and
    raises, as the reference does. The round runs on ``dp`` banks (the
    engine passes no policy).
    """

    def __init__(self, params, opt_state, capacity: int, mesh=None, policy: str = "dp"):
        self.mesh = mesh
        self.policy = policy
        self.n_shards = cohort_size(mesh)
        self.capacity = padded_capacity(capacity, self.n_shards)
        self.slots_per_shard = self.capacity // self.n_shards
        # the device of the assembled (capacity, ...) view: the params' own
        self.home = leaves(params)[0].device
        self.groups = [ShardGroup(self.home, (0,))] if mesh is None else shard_groups(mesh)
        self.group_slots = bank_placement(self.groups, self.slots_per_shard)
        self.group_of = np.zeros(self.capacity, np.int64)
        self.local_of = np.zeros(self.capacity, np.int64)
        for g, slots in enumerate(self.group_slots):
            self.group_of[slots] = g
            self.local_of[slots] = np.arange(slots.size)
        self.sharded = mesh is not None and policy != "dp" and mesh.model > 1
        self.placed_params = self.placed_opt = None
        if mesh is not None and policy != "dp":
            cap = self.capacity

            def shapes(tree):
                return tree_map(lambda a: torch.empty((cap,) + tuple(a.shape), dtype=a.dtype, device="meta"),
                                tree)

            # raises for an axis the mesh lacks (fsdp's data axis)
            self._params_sh = bank_shardings(shapes(params), mesh, policy)
            self._opt_sh = bank_shardings(shapes(opt_state), mesh, policy)
        if self.sharded:
            def stack0(a, sh):  # a leaf's (capacity, ...) stack, slot 0 = a, in its pieces
                out = torch.zeros((cap,) + tuple(a.shape), dtype=a.dtype, device=a.device)
                out[0] = a
                return place(out, sh)

            self.group_params = self.group_opt = None
            self.placed_params = tree_map(stack0, params, self._params_sh)
            self.placed_opt = tree_map(stack0, opt_state, self._opt_sh)
        else:
            def stack(a, g):
                dev = self.groups[g].device
                out = torch.zeros((self.group_slots[g].size,) + tuple(a.shape), dtype=a.dtype, device=dev)
                if self.group_of[0] == g:
                    out[int(self.local_of[0])] = a.to(dev)
                return out

            self.group_params = [tree_map(lambda a: stack(a, g), params) for g in range(len(self.groups))]
            self.group_opt = [tree_map(lambda a: stack(a, g), opt_state) for g in range(len(self.groups))]
        self.slot_of: Dict[str, int] = {"0": 0}
        self.id_of: Dict[int, str] = {0: "0"}
        self.clock = np.zeros(self.capacity, np.float64)
        self.rounds = np.zeros(self.capacity, np.int64)
        self._next = 1  # number of allocated slots (allocation counter)

    # ---------------------------------------------- the (capacity, ...) view
    def assemble(self, groups_tree: list):
        """The (capacity, ...) view of per-group trees: the group's own
        tensors for one group, else a copy in slot order on ``home``."""
        if len(self.groups) == 1:
            return groups_tree[0]
        sps = self.slots_per_shard
        parts = []
        for j in range(self.n_shards):
            g = next(i for i, gr in enumerate(self.groups) if j in gr.shards)
            pos = self.groups[g].shards.index(j)
            parts.append(tree_map(lambda a: a[pos * sps:(pos + 1) * sps].to(self.home), groups_tree[g]))
        return tree_map(lambda *blocks: torch.cat(blocks), *parts)

    def _split(self, tree) -> list:
        tree = tree_map(lambda a: a.whole(self.home) if isinstance(a, Placed) else a, tree)
        if len(self.groups) == 1:
            return [tree]
        return [
            tree_map(lambda a: a[torch.as_tensor(slots, device=a.device)].to(gr.device), tree)
            for gr, slots in zip(self.groups, self.group_slots)
        ]

    def _placed(self, tree, shardings):
        """A tree of whole (capacity, ...) tensors in this bank's pieces; a
        leaf already in them (``scatter_allocations`` with this bank's
        ``bank_shardings``) is taken as it is."""
        return tree_map(lambda a, sh: a if isinstance(a, Placed) and a.sharding == sh else place(
            a.whole() if isinstance(a, Placed) else a, sh), tree, shardings)

    @property
    def params(self):
        if self.sharded:
            return tree_map(lambda a: a.whole(self.home), self.placed_params)
        return self.assemble(self.group_params)

    @params.setter
    def params(self, tree):
        if self.sharded:
            self.placed_params = self._placed(tree, self._params_sh)
        else:
            self.group_params = self._split(tree)

    @property
    def opt_state(self):
        if self.sharded:
            return tree_map(lambda a: a.whole(self.home), self.placed_opt)
        return self.assemble(self.group_opt)

    @opt_state.setter
    def opt_state(self, tree):
        if self.sharded:
            self.placed_opt = self._placed(tree, self._opt_sh)
        else:
            self.group_opt = self._split(tree)

    def shardings(self):
        """(params, opt_state) trees of ``CohortSharding``: the placement
        ``scatter_allocations``/``repack_stacked`` take as
        ``out_shardings`` (None without a mesh or under ``dp``)."""
        if self.mesh is None or self.policy == "dp":
            return None, None
        return self._params_sh, self._opt_sh

    # ------------------------------------------------------- slot algebra
    def shard_of(self, slot: int) -> int:
        """Mesh position of the shard owning ``slot``."""
        return slot // self.slots_per_shard

    def _alloc_slot(self, n: int) -> int:
        """Slot id of the n-th allocation: round-robin across shard blocks
        so concurrently-live cohorts land on different shards."""
        if self.n_shards == 1:
            return n
        return (n % self.n_shards) * self.slots_per_shard + n // self.n_shards

    def params_of(self, cohort_id: str):
        i = self.slot_of[cohort_id]
        g, row = int(self.group_of[i]), int(self.local_of[i])
        if self.sharded:
            return tree_map(lambda a: a.slot(g, row, self.home), self.placed_params)
        return tree_map(lambda a: a[row], self.group_params[g])

    def opt_state_of(self, cohort_id: str):
        i = self.slot_of[cohort_id]
        g, row = int(self.group_of[i]), int(self.local_of[i])
        if self.sharded:
            return tree_map(lambda a: a.slot(g, row, self.home), self.placed_opt)
        return tree_map(lambda a: a[row], self.group_opt[g])

    def spawn_children(self, parent: str, children: List[str]) -> List[int]:
        """Warm-start child slots from the parent slot (§4.2)."""
        ps = self.slot_of[parent]
        idx = []
        for ch in children:
            if self._next >= self.capacity:
                raise RuntimeError(f"CohortBank capacity {self.capacity} exhausted at {ch}")
            slot = self._alloc_slot(self._next)
            self.slot_of[ch] = slot
            self.id_of[slot] = ch
            idx.append(slot)
            self._next += 1
        pg, prow = int(self.group_of[ps]), int(self.local_of[ps])
        dst = {}
        for s in idx:
            dst.setdefault(int(self.group_of[s]), []).append(int(self.local_of[s]))
        if self.sharded:
            self.placed_params = tree_map(lambda a: a.copy_rows(pg, prow, dst), self.placed_params)
            self.placed_opt = tree_map(lambda a: a.copy_rows(pg, prow, dst), self.placed_opt)
        else:
            src_p = tree_map(lambda a: a[prow], self.group_params[pg])
            src_o = tree_map(lambda a: a[prow], self.group_opt[pg])
            new_p, new_o = list(self.group_params), list(self.group_opt)
            for g, rows in dst.items():
                # the parent's row goes to group g's device once for all its children
                new_p[g] = tree_map(lambda a, v: _set_rows(a, rows, v.to(a.device)), new_p[g], src_p)
                new_o[g] = tree_map(lambda a, v: _set_rows(a, rows, v.to(a.device)), new_o[g], src_o)
            self.group_params, self.group_opt = new_p, new_o
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
    """Stage-① output: the round's flat, fixed-width execution layout.

    B = n_shards * shard_width; under sharding rows [j*W, (j+1)*W) are
    block j and hold only participants of cohorts placed in shard j (plus
    padding). ``order`` is the layout-free canonical fill order (leaf by
    leaf, in tree order; the first ``n_real`` entries are the real rows):
    host data sampling and per-row threefry keys follow it, so sharded and
    single-device runs draw the same streams. On one device it is the
    identity.
    """

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
    order: np.ndarray  # (B,) int32 canonical row order; first n_real real
    n_real: int  # real participant rows this round
    dropped: int  # participants dropped to a full shard row block (§④)


class ExecResult:
    """Stage-② output: per-row sketches (B, d_sketch) and losses (B,) as
    numpy arrays.

    ``ExecResult.fetch(..., lazy=True)`` of CUDA tensors (the §⑤ overlap)
    queues their copies to the host behind the round's step, into pinned
    buffers, and records an event after them: the dispatch returns at once,
    and the first read (stage ③, a round later) waits on the event. The
    buffers hold stale bytes until the event has completed, so every read
    goes through the properties. Under sharding each device group's rows
    come back on their own and are put in row order at the first read.
    """

    def __init__(self, sketches, losses, ready=None, rows=None):
        # numpy arrays; or, with ``rows`` (each group's row ids), lists of
        # per-group arrays
        self._sketches = sketches
        self._losses = losses
        self._ready = ready  # torch.cuda.Events recorded after the copies, or None
        self._rows = rows

    @classmethod
    def fetch(cls, sketches: torch.Tensor, losses: torch.Tensor, lazy: bool) -> "ExecResult":
        if not (lazy and sketches.is_cuda):
            return cls(sketches.cpu().numpy(), losses.cpu().numpy())
        hs = torch.empty(sketches.shape, dtype=sketches.dtype, pin_memory=True)
        hl = torch.empty(losses.shape, dtype=losses.dtype, pin_memory=True)
        hs.copy_(sketches, non_blocking=True)
        hl.copy_(losses, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return cls(hs.numpy(), hl.numpy(), [ready])

    @classmethod
    def gather(cls, parts, lazy: bool, rows) -> "ExecResult":
        """``parts``: each device group's (sketches, losses, device), fetched
        on that device's stream; ``rows``: each group's row ids, or None
        when one group holds every row in order."""
        got = []
        for sk, ls, dev in parts:
            with _on(dev):
                got.append(cls.fetch(sk, ls, lazy))
        if rows is None:
            return got[0]
        ready = [ev for r in got for ev in (r._ready or ())]
        return cls([r._sketches for r in got], [r._losses for r in got], ready or None, rows)

    def _wait(self):
        for ev in self._ready or ():
            ev.synchronize()
        self._ready = None
        if self._rows is not None:
            n = sum(r.size for r in self._rows)
            sk = np.empty((n,) + self._sketches[0].shape[1:], self._sketches[0].dtype)
            ls = np.empty((n,), self._losses[0].dtype)
            for r, a, b in zip(self._rows, self._sketches, self._losses):
                sk[r], ls[r] = a, b
            self._sketches, self._losses, self._rows = sk, ls, None

    @property
    def sketches(self) -> np.ndarray:
        self._wait()
        return self._sketches

    @property
    def losses(self) -> np.ndarray:
        self._wait()
        return self._losses


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------
class RoundPipeline:
    """Drives one global round.

    mode="batched"    — one fused step for the execution stage (one per
                        device group under sharding) and one batched pass
                        for the feedback clustering, independent of the
                        leaf-cohort count.
    mode="sequential" — reference oracle: same plan, same feedback
                        application, per-cohort training launches.

    With ``FLConfig.cohort_shards = S > 1`` (batched mode only) the bank and
    the flat row axis split over an S-shard cohort mesh and the round runs
    with no collective (see the module docstring).
    """

    def __init__(self, engine, mode: str = "batched"):
        if mode not in ("batched", "sequential"):
            raise ValueError(f"execution={mode!r}: 'batched' or 'sequential'")
        fl, auxo = engine.fl, engine.auxo
        # §⑤ round pipelining: 0 = synchronous, 1 = depth-2 overlap
        self.overlap = int(fl.round_overlap)
        if self.overlap not in (0, 1):
            raise ValueError("only depth-2 overlap (round_overlap=1)")
        if self.overlap and mode != "batched":
            raise ValueError("round overlap requires the batched pipeline")
        self.eng = engine
        self.mode = mode
        capacity, self.max_leaves = bank_capacity(auxo)
        self.n_shards = max(1, int(fl.cohort_shards or 1))
        if self.n_shards > 1:
            if mode != "batched":
                raise ValueError("cohort sharding requires the batched pipeline")
            self.mesh = make_cohort_mesh(self.n_shards, devices=engine.devices, device=engine.device)
        else:
            self.mesh = None
        self.bank = CohortBank(
            engine._init_params, engine.server_opt.init(engine._init_params), capacity,
            mesh=self.mesh,
        )
        # §⑥ population plane: with FLConfig.population_store the table is
        # a view over the engine's chunked PopulationStore (same method API,
        # same bit-level math, O(touched clients) memory)
        if engine.store is not None:
            self.table = ChunkedAffinityTable(engine.store)
            if self.table.capacity != self.bank.capacity:
                raise ValueError(f"store columns {self.table.capacity} != bank capacity {self.bank.capacity}")
        else:
            self.table = AffinityTable(engine.data.n_clients, self.bank.capacity)
        self._all_ids_cache: Optional[np.ndarray] = None
        # flat execution width: the full round budget, fixed for the run;
        # L·quota(L) ≤ max(int(P·oc), 2·L) for every leaf count L
        self.width = max(2, int(fl.participants_per_round * fl.overcommit), 2 * self.max_leaves)
        # per-shard row block (§④): the default, 2·width/S (twice the
        # balanced share), absorbs leaf-placement skew; a cohort whose block
        # fills trains with fewer participants that round (counted in
        # dropped_rows). rows_per_shard = width keeps single-device
        # semantics at the cost of S·width padded rows.
        if self.n_shards == 1:
            self.shard_width = self.width
        else:
            auto = min(self.width, max(2, -(-2 * self.width // self.n_shards)))
            self.shard_width = int(fl.rows_per_shard or auto)
        self.exec_width = self.shard_width * self.n_shards
        # each device group's rows, in its stacked buffers' order (None: one
        # group holds every row in order)
        self.group_rows = (
            None if len(self.bank.groups) == 1
            else row_placement(self.bank.groups, self.shard_width)
        )
        self.exec_dispatches = 0  # stage-② steps (one a round; one per cohort in sequential)
        self.dropped_rows = 0  # participants dropped to full shard blocks
        # host control plane (§⑤): with the overlap on, stage-①/③ control
        # math runs as numpy twins; overridable for the staleness oracle
        self.host_control = bool(self.overlap)
        if self.overlap:
            engine.coordinator.use_host_states()
        self._inflight: Optional[Tuple[MatchPlan, ExecResult]] = None  # dispatched, not retired
        self._staged: Optional[Tuple[int, Any, Any]] = None  # (round, plan, packed)
        # §⑨ host copies (xs, ys, inv) of the staged round's row buffers:
        # the device-staged tuple is layout-bound, checkpoint.run_state
        # saves these and re-stages them on load
        self._staged_host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self.flushes = 0  # partition-triggered pipeline flushes
        # §⑧ serving snapshot: the newest bank state consistent with the
        # host tables (a round boundary), as the bank's per-group trees.
        # Bank updates replace them, so holding them is a snapshot. With
        # the overlap on, the live bank is round r while the tables hold
        # round r-1: run_round publishes the pre-dispatch bank then, the
        # drained bank after a flush.
        self._serve = self.bank.group_params
        # cumulative host wall-time per stage
        self.stage_seconds = {"plan": 0.0, "pack": 0.0, "dispatch": 0.0, "feedback": 0.0}

    @property
    def serve_params(self):
        """The serving snapshot as a (capacity, ...) tree."""
        return self.bank.assemble(self._serve)

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
            if getattr(eng.trace, "mode", "compat") == "chunked":
                # §⑥ streaming availability: per-chunk Poisson counts +
                # in-chunk id sampling, capped at a candidate pool around
                # the round budget (the full active set is never built)
                pool = max(4 * self.exec_width, 2 * int(fl.participants_per_round))
                avail, _n_avail = eng.trace.sample(r, pool, eng.rng)
            else:
                avail = np.asarray(eng.trace.available(r, eng.rng))
        else:
            avail = self._all_ids
        if eng.store is not None and eng.store.n_departed:
            avail = avail[eng.store.alive(avail)]  # churned-out clients skip rounds
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
        B, W = self.exec_width, self.shard_width
        slot_rows = np.zeros(B, np.int32)
        client_rows = np.zeros(B, np.int32)
        real = np.zeros(B, bool)
        kept = np.zeros(B, bool)
        claim_rows = np.zeros(B, bool)
        update_slots = np.zeros(self.bank.capacity, bool)
        durations: Dict[str, float] = {}
        active: List[str] = []
        cursors = np.zeros(self.n_shards, np.int64)  # fill level per block
        order_list: List[int] = []  # canonical (layout-free) order
        dropped = 0
        for li, leaf in enumerate(leaves):
            cand = avail[want == li]
            if cand.size < 2:
                continue
            ccl = claimed[want == li]
            take = min(quota, cand.size)
            # §④ per-shard participant capacity: a cohort trains with at
            # most the free rows of its slot's shard block
            shard = self.bank.shard_of(int(slots[li]))
            space = int(W - cursors[shard])
            if take > space:
                dropped += take - space
                take = space
            if take < 2:
                dropped += take
                continue
            sel = eng.rng.choice(cand.size, size=take, replace=False)
            part = cand[sel]
            # over-commitment straggler drop: latency is a pure function of
            # device speeds, so the kept set is known before execution
            kept_ids, duration = eng.speeds.round_duration(
                part, fl.local_steps * fl.batch_size, overcommit=fl.overcommit
            )
            base = shard * W + int(cursors[shard])
            rows = slice(base, base + take)
            slot_rows[rows] = slots[li]
            client_rows[rows] = part
            real[rows] = True
            kept[rows] = np.isin(part, kept_ids)
            claim_rows[rows] = ccl[sel]
            update_slots[slots[li]] = True
            durations[leaf] = duration
            active.append(leaf)
            cursors[shard] += take
            order_list.extend(range(rows.start, rows.stop))
        n_real = len(order_list)
        if n_real == 0:
            return None
        # padding rows replicate their block's first row (weight 0, never
        # kept); an EMPTY block pads with its shard's first local slot, so
        # the per-row param gather never leaves the shard
        first_real = order_list[0]
        for j in range(self.n_shards):
            lo, hi = j * W + int(cursors[j]), (j + 1) * W
            if lo == hi:
                continue
            src = j * W if cursors[j] > 0 else first_real
            slot_rows[lo:hi] = slot_rows[src] if cursors[j] > 0 else j * self.bank.slots_per_shard
            client_rows[lo:hi] = client_rows[src]
        order = np.concatenate(
            [np.asarray(order_list, np.int64), np.flatnonzero(~real)]
        ).astype(np.int32)
        if not fl.allow_cross_cohort_duplicates:
            check_cross_cohort_unique(client_rows, kept)
        self.dropped_rows += dropped
        sizes = eng.data.client_sizes(client_rows).astype(np.float32)
        return MatchPlan(
            round_idx=r, leaves=leaves, active=active, slot_rows=slot_rows,
            client_rows=client_rows, real=real, kept=kept, claimed=claim_rows,
            sizes=sizes, update_slots=update_slots, durations=durations,
            key_seed=int(eng.rng.integers(2**31)), order=order, n_real=n_real,
            dropped=dropped,
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
                if self.host_control:
                    # §⑤: numpy twin — a kernel launch and its fetch here
                    # would wait on the round in flight
                    sims = _cosine_np(fps, idents)
                else:
                    # no power-of-two padding of the batch (the JAX package
                    # pads to avoid recompiles; the CUDA kernel takes any P)
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
        # §⑥/⑦ churn-aware matching (FLConfig.warm_rearrivals): a
        # re-arrival's check-ins probe the root model and seed its affinity
        # from the probe fingerprint's nearest-identity leaf instead of
        # re-exploring cold. The marker is consumed on actual PARTICIPATION
        # (stage-③ kept rows, see _consume_rearrivals), not here. The probe
        # is a training launch whose result the host reads: under
        # round_overlap=1 it waits on the round in flight (opt-in policy).
        if (
            eng.fl.warm_rearrivals
            and eng.store is not None
            and eng.global_mu_seen
            and len(eng.coordinator.identity) >= 2
        ):
            warm = eng.store.gather("rearrived", avail)
            if warm.any():
                pf = eng._probe_fingerprints(avail[warm])
                best, _m, il = eng.coordinator.match_many(pf)
                # the one-line policy: check in at the nearest identity
                want[warm] = np.array([leaves.index(l) for l in il])[best]
        claimed = known_any & (want == exploit)
        return want, claimed

    def _consume_rearrivals(self, plan: MatchPlan):
        """One-shot warm-rearrival markers clear when a re-arrival actually
        LANDS a kept row (it now holds a real reward record): clearing at
        match time would waste the seed on clients the quota skipped, or on
        plans a partition flush later discards."""
        store = self.eng.store
        if not self.eng.fl.warm_rearrivals or store is None:
            return
        kept_ids = plan.client_rows[plan.kept]
        if kept_ids.size:
            warm = store.gather("rearrived", kept_ids)
            if warm.any():
                store.scatter("rearrived", kept_ids[warm], False)

    # ------------------------------------------------------------ stage ②
    def _exec_step(self, slot_rows, xs, ys, seed, inv, sizes, kept, upd, block_ids=None,
                   group: int = 0):
        """One device group's round: every leaf cohort's local training,
        masked aggregation and server optimizer over the group's stacked
        bank -> (new params, new opt state, sketches (R, d_sketch), losses
        (R,)).

        ``slot_rows`` index the group's stacked bank (global slot ids on one
        device); ``block_ids`` (n, W) are the same rows' block-local slot
        ids (None: one block, the slot rows themselves). Each sum is one
        launch over the group's n row blocks into their ``slots_per_shard``
        slots each, no row reaching another shard's slots."""
        eng, fl = self.eng, self.eng.fl
        bparams, bopt = self.bank.group_params[group], self.bank.group_opt[group]
        # per-row threefry keys: row i uses split(key(seed), B)[inv[i]], the
        # JAX package's stream in the plan's canonical order, so a row's key
        # does not depend on the layout; only DP noise draws from them
        keys = None
        if fl.dp_clip > 0.0 and fl.dp_sigma > 0.0:
            keys = rnd.split(rnd.key(seed, device=xs.device), self.exec_width)[inv]
        prow = {k: a[slot_rows] for k, a in bparams.items()}  # gather
        deltas, losses = local_train(
            eng.task.loss, prow, xs, ys, keys, lr=fl.lr, prox_mu=fl.prox_mu,
            dp_clip=fl.dp_clip, dp_sigma=fl.dp_sigma,
        )
        # masked per-cohort aggregation (q-FedAvg or size weighting)
        wr = torch.pow(torch.clamp(losses, min=1e-6), fl.qfed_q) if fl.qfed_q > 0 else sizes
        wr = wr * kept
        names = sorted(deltas)
        flat = torch.cat([deltas[k].reshape(slot_rows.shape[0], -1) for k in names], dim=1)
        if block_ids is None:
            block_ids = slot_rows.view(1, -1)
        n, W = block_ids.shape
        sps = self.bank.slots_per_shard
        denom = kops.segment_aggregate(wr.view(n, W, 1), block_ids, sps).reshape(n * sps)
        w = wr / torch.clamp(denom[slot_rows], min=1e-9)
        agg_flat = kops.segment_aggregate(  # (n * sps, n_params)
            flat.view(n, W, -1), block_ids, sps, weights=w.view(n, W)
        ).reshape(n * sps, -1)
        agg, off = {}, 0
        for k in names:
            m = bparams[k][0].numel()
            agg[k] = agg_flat[:, off:off + m].reshape(bparams[k].shape)
            off += m
        new_p, new_o = apply_stacked(eng.server_opt, bparams, bopt, agg, upd)
        sketches = eng.sketcher.batch(deltas)
        return new_p, new_o, sketches, losses

    def _pack_rows(self, plan: MatchPlan):
        """Host-side data plane: local batches for every row as ONE batched
        population draw in the plan's canonical order (so every shard layout
        draws the same stream); padding rows replicate the first real row's
        batch with weight 0. Batched mode stages them on the device(s)
        (``_stage_buffers``); the sequential oracle keeps host arrays plus
        per-row threefry keys drawn on the host, row i's key
        ``split(key(key_seed), B)[inv[i]]``."""
        eng, fl = self.eng, self.eng.fl
        B = plan.slot_rows.shape[0]
        order_real = plan.order[: plan.n_real]
        cids = plan.client_rows[order_real]
        xs_r, ys_r = eng.data.sample_batches(cids, fl.batch_size, fl.local_steps, eng.rng)
        if eng.corrupted:
            bad = np.isin(cids, np.fromiter(eng.corrupted, np.int64, len(eng.corrupted)))
            if bad.any():
                ys_r[bad] = eng.rng.integers(
                    0, eng.data.n_classes, size=ys_r[bad].shape
                ).astype(ys_r.dtype)
        xs = np.zeros((B,) + xs_r.shape[1:], xs_r.dtype)
        ys = np.zeros((B,) + ys_r.shape[1:], ys_r.dtype)
        xs[order_real] = xs_r
        ys[order_real] = ys_r
        pad = plan.order[plan.n_real:]
        src = int(plan.order[0])
        xs[pad] = xs[src]
        ys[pad] = ys[src]
        inv = np.empty(B, np.int64)
        inv[plan.order] = np.arange(B)
        if self.mode != "batched":
            return xs, ys, rnd.split(rnd.key(plan.key_seed), B)[torch.from_numpy(inv)]
        inv32 = inv.astype(np.int32)
        if self.overlap:
            # the last _pack_rows of a run_round is the staged next round
            self._staged_host = (xs, ys, inv32)
        return self._stage_buffers(plan, xs, ys, inv32)

    def _stage_buffers(self, plan: MatchPlan, xs, ys, inv) -> list:
        """One round's row buffers on the device(s), execution-ready: per
        device group, the arguments of ``_exec_step`` and its block-local
        slot ids (None for one shard). Under the overlap on the card each
        buffer goes up from pinned memory by an asynchronous copy, queued
        behind the round in flight, so the host goes on; PyTorch's
        pinned-memory cache hands a staging buffer out again only after the
        event of its copy has completed, so a buffer is never rewritten
        under a pending copy."""
        bank, W, sps = self.bank, self.shard_width, self.bank.slots_per_shard
        noise = self.eng.fl.dp_clip > 0.0 and self.eng.fl.dp_sigma > 0.0  # the keys' only use
        out = []
        for g, grp in enumerate(bank.groups):
            dev = grp.device
            pinned = self.overlap and dev.type == "cuda"

            def put(a):
                t = torch.from_numpy(np.ascontiguousarray(a))
                if pinned:
                    return t.pin_memory().to(dev, non_blocking=True)
                return t.to(dev)

            rows = None if self.group_rows is None else self.group_rows[g]
            take = (lambda a: a) if rows is None else (lambda a: a[rows])
            slots = take(plan.slot_rows).astype(np.int64)
            block_ids = None  # one shard: its rows' slot ids are the block's
            if self.n_shards > 1:
                # block-local slot ids: row block j only references shard j's slots
                row_ids = np.arange(plan.slot_rows.size) if rows is None else rows
                block_ids = put((slots - (row_ids // W) * sps).reshape(len(grp.shards), W))
            args = (
                put(bank.local_of[slots]),
                put(take(xs)),
                put(take(ys)),
                int(plan.key_seed),
                put(take(inv).astype(np.int64)) if noise else None,
                put(take(plan.sizes)),
                put(take(plan.kept).astype(np.float32)),
                put(plan.update_slots[bank.group_slots[g]]),
            )
            out.append((args, block_ids))
        return out

    def execute(self, plan: MatchPlan, packed=None) -> ExecResult:
        """Stage ②: run the round's training on the device. Under the
        overlap the returned ExecResult is read lazily (stage ③); ``packed``
        lets the §⑤ scheduler pass buffers packed a round ahead."""
        eng, fl = self.eng, self.eng.fl
        if packed is None:
            packed = self._timed("pack", self._pack_rows, plan)
        t0 = time.perf_counter()
        if self.mode == "batched":
            res = self._execute_batched(packed)
        else:
            res = self._execute_sequential(plan, *packed)
        self.stage_seconds["dispatch"] += time.perf_counter() - t0
        # simulated wall-clock + resource accounting
        for leaf in plan.active:
            slot = self.bank.slot_of[leaf]
            self.bank.clock[slot] += plan.durations[leaf]
            self.bank.rounds[slot] += 1
        eng.resource_used += int(plan.real.sum()) * fl.local_steps * fl.batch_size
        return res

    def _execute_batched(self, staged) -> ExecResult:
        """One step per device group, each on its device's current stream;
        the host issues them one after another, so the devices run them at
        the same time."""
        bank = self.bank
        new_p, new_o, parts = list(bank.group_params), list(bank.group_opt), []
        for g, (args, block_ids) in enumerate(staged):
            dev = bank.groups[g].device
            with torch.no_grad(), _on(dev):
                new_p[g], new_o[g], sketches, losses = self._exec_step(
                    *args, block_ids=block_ids, group=g
                )
            parts.append((sketches, losses, dev))
        self.exec_dispatches += 1
        bank.group_params, bank.group_opt = new_p, new_o
        return ExecResult.gather(parts, bool(self.overlap), self.group_rows)

    def _execute_sequential(self, plan: MatchPlan, xs, ys, keys) -> ExecResult:
        """Reference oracle: one padded training launch PER cohort, a
        ``tensordot`` aggregation and an eager server-optimizer update
        written into the cohort's slot."""
        eng, fl = self.eng, self.eng.fl
        dev = eng.device
        B = plan.slot_rows.shape[0]
        sketches = np.zeros((B, eng.auxo.d_sketch), np.float32)
        losses = np.zeros((B,), np.float32)
        quota = max(2, int(fl.participants_per_round * fl.overcommit / len(plan.leaves)))
        for leaf in plan.active:
            slot = self.bank.slot_of[leaf]
            rows = np.nonzero(plan.real & (plan.slot_rows == slot))[0]
            pad = np.concatenate([rows, np.repeat(rows[0], quota - rows.size)])
            params = self.bank.params_of(leaf)
            with torch.no_grad():
                deltas, loss_c = eng._train_cohort(
                    params,
                    torch.from_numpy(xs[pad]).to(dev),
                    torch.from_numpy(ys[pad]).to(dev),
                    keys[torch.from_numpy(pad)].to(dev),
                )
            self.exec_dispatches += 1
            loss_np = loss_c.cpu().numpy()
            if fl.qfed_q > 0:
                w = np.power(np.maximum(loss_np, 1e-6), fl.qfed_q)
            else:
                w = plan.sizes[pad].astype(np.float32)
            w = w * np.concatenate([plan.kept[rows], np.zeros(quota - rows.size)]).astype(np.float32)
            w = torch.as_tensor(w / max(w.sum(), 1e-9), dtype=torch.float32, device=dev)
            agg = {k: torch.tensordot(w, d, dims=1) for k, d in deltas.items()}
            new_p, new_o = eng.server_opt.apply(params, self.bank.opt_state_of(leaf), agg)
            self.bank.params = tree_map(lambda a, v: _set_rows(a, slot, v), self.bank.params, new_p)
            self.bank.opt_state = tree_map(
                lambda a, v: _set_rows(a, slot, v), self.bank.opt_state, new_o
            )
            if eng.auxo.enabled:
                with torch.no_grad():
                    sk = eng.sketcher.batch(deltas).cpu().numpy()
                sketches[rows] = sk[: rows.size]
            losses[rows] = loss_np[: rows.size]
        return ExecResult(sketches, losses)

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
        self._consume_rearrivals(plan)
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

        if not self.host_control:  # the host control plane keeps numpy
            fp_batch = torch.from_numpy(fp_batch).to(eng.device)
            masks = torch.from_numpy(masks).to(eng.device)
        results = eng.coordinator.feedback_all(
            plan.active,
            [k.tolist() for k in kept_ids_list],
            fp_batch,
            masks,
            plan.round_idx,
            fl.rounds,
            claimed_list,
            batched=(self.mode == "batched"),
            backend="host" if self.host_control else "device",
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
    def _plan_and_pack(self, r: int) -> Tuple[int, Any, Any]:
        plan = self._timed("plan", self.plan_round, r)
        if plan is None:
            if self.overlap:
                self._staged_host = None  # no buffers ride with an empty round
            return (r, None, None)
        packed = self._timed("pack", self._pack_rows, plan)
        return (r, plan, packed)

    def _retire(self) -> bool:
        """Apply the in-flight round's feedback (True iff it partitioned)."""
        if self._inflight is None:
            return False
        plan, res = self._inflight
        self._inflight = None
        return self.apply_feedback(plan, res)

    def flush(self):
        """Drain the pipeline: retire the in-flight round's feedback, so
        host tables and fingerprints are consistent with the bank. A
        partition during the drain discards the staged next-round plan (it
        was computed against pre-partition tables); otherwise the staged
        plan survives, its one-round staleness being the steady-state
        semantics. No-op in synchronous mode and on an empty pipeline."""
        if self._retire():
            self._staged = None
            self._staged_host = None
        self._serve = self.bank.group_params

    def run_round(self, r: int):
        if not self.overlap:
            plan = self._timed("plan", self.plan_round, r)
            if plan is None:
                return
            self.apply_feedback(plan, self.execute(plan))
            self._serve = self.bank.group_params
            return
        # §⑤ depth-2 overlapped schedule. Host-visible order per call:
        #   wait for round r-1's sketches/losses (its event: the ONLY wait
        #     of stage ③ on the card; the card's queue is then empty)
        #   → dispatch round r (plan/buffers staged by the previous call)
        #   → apply round r-1's feedback        ┐ host-control numpy, all
        #   → plan round r+1 (one-round-stale)  │ overlapped with the card
        #   → pack + stage its buffers          ┘ executing round r
        staged, self._staged = self._staged, None
        prev, self._inflight = self._inflight, None
        if prev is not None:
            prev[1].sketches, prev[1].losses  # lazy fetch, before dispatch
        if staged is not None and staged[0] == r:
            _, plan, packed = staged
        else:
            _, plan, packed = self._plan_and_pack(r)
        # serving snapshot candidate: the bank BEFORE round r's dispatch
        # replaces it (round r-1's values, consistent with the tables once
        # prev's feedback lands)
        pre = self.bank.group_params
        res = self.execute(plan, packed) if plan is not None else None
        events = prev is not None and self.apply_feedback(*prev)
        if plan is not None:
            if events:
                # pipeline FLUSH: the partition invalidated round r's stale
                # plan (it trained the pre-partition leaf set one extra
                # round): drain it synchronously, so the next plan sees
                # fully reseeded tables
                self.flushes += 1
                self.apply_feedback(plan, res)
            else:
                self._inflight = (plan, res)
        # publish the serving snapshot for the gap ahead: boundary r-1
        # while round r stays in flight, boundary r if it was drained
        self._serve = self.bank.group_params if self._inflight is None else pre
        # stage round r+1 against the current tables: they miss only round
        # r's feedback (in flight), stale by exactly one round
        self._staged = self._plan_and_pack(r + 1)
