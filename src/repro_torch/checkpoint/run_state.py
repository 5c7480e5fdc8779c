"""Whole-run checkpoint/restore with elastic remesh (port of
``repro.checkpoint.run_state``, ARCHITECTURE.md §⑨).

``save_run(path, engine)`` writes everything a run is: the CohortBank
(params, optimizer state, clocks) in allocation order, the cohort tree with
every clusterer's state and threefry key, the affinity tables (dense, or
the chunked PopulationStore), fingerprints and probe caches, the churn
stream, the data-plane recipe, the host RNG state, the §⑤ pipeline's
staged next-round plan with its host buffers, and the round cursor.
``load_run(path)`` rebuilds a live ``AuxoEngine`` that continues bit-equal
to a run that never stopped.

The files are the JAX package's: ``meta.json`` plus ``.npz`` files with
flat keys (bank trees under JAX key paths, clusterer keys as uint32 key
data), so a run saved by either package restores in the other. The task
is recorded by module and class: a checkpoint of the JAX package names
``repro.fl.task``, which ``load_run`` reads as ``repro_torch.fl.task``
(the names are mapped as strings; nothing of the JAX package is
imported). A checkpoint written here names ``repro_torch.fl.task``; the
JAX package loads it with ``task=``.

Round overlap: ``save_run`` drains the pipeline (``flush()``) first, so a
differential harness flushes its continuous comparator at the save round
too (checkpoints happen at round boundaries, where evaluation drains).

Remesh: slot ids depend on the shard count (allocation n lives at slot
``(n % S)*slots_per_shard + n//S``), so the bank, clocks and affinity
columns are saved in allocation order and scattered into the new layout's
slots on load (``launch/sharding.alloc_slots``/``scatter_allocations``;
``scale.store.remap_affinity_slots`` for the store). A STAGED plan's
buffers are layout-bound (block-local slot ids, the row width), so a
restore of one onto another shard count raises.

``device``/``devices`` place the restored engine (as ``AuxoEngine``'s), so
a run saved on one device restores onto another. Child clusterers of a
partition AFTER the restore are seeded from ``hash(child_id)``, which
Python randomizes per process: a restore in another process may part from
the saved run at its first new partition unless PYTHONHASHSEED is pinned.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.npz import (
    load_data_plane,
    load_population_store,
    load_pytree,
    save_data_plane,
    save_population_store,
    save_pytree,
)
from repro_torch.convert import cluster_state_from_numpy
from repro_torch.core.clustering import ClusterState, OnlineClustering, host_array, host_state
from repro_torch.core.cohort import CohortNode
from repro_torch.core.coordinator import CohortStats, PartitionEvent
from repro_torch.launch.sharding import alloc_slots, scatter_allocations
from repro_torch.scale.churn import ChurnStream
from repro_torch.scale.store import adopt_store_state, remap_affinity_slots
from repro_torch.utils.tree import tree_map

_VERSION = 1

# MatchPlan's array-valued fields, saved as they are (host numpy)
_PLAN_ARRAYS = (
    "slot_rows", "client_rows", "real", "kept", "claimed", "sizes",
    "update_slots", "order",
)


def _jsonable(obj):
    """Coerce numpy scalars (recursively) so json.dump takes the meta dict."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def _alloc_order_ids(bank) -> list:
    """Cohort ids in allocation order (the layout-free key)."""
    return [bank.id_of[bank._alloc_slot(n)] for n in range(bank._next)]


def _task_module(name: str) -> str:
    """The port's module for a task recorded by either package."""
    if name == "repro" or name.startswith("repro."):
        return "repro_torch" + name[len("repro"):]
    return name


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
def save_run(path: str | Path, engine, next_round: Optional[int] = None):
    """Checkpoint the whole run into directory ``path``. Drains the §⑤
    pipeline first (``flush()``), so the saved tables agree with the saved
    bank. ``next_round`` defaults to ``engine.round_cursor``."""
    eng = engine
    pipe = eng.pipeline
    bank = pipe.bank
    pipe.flush()
    if next_round is None:
        next_round = eng.round_cursor

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    # ---- the bank in allocation order
    alloc_ids = _alloc_order_ids(bank)
    A = len(alloc_ids)
    old_slots = alloc_slots(A, bank.capacity, bank.n_shards)
    idx = torch.from_numpy(old_slots)
    canon = lambda t: tree_map(lambda a: a[idx.to(a.device)], t)  # noqa: E731
    save_pytree(path / "bank_params.npz", canon(bank.params))
    save_pytree(path / "bank_opt.npz", canon(bank.opt_state))

    arrays: Dict[str, np.ndarray] = {
        "bank:clock": bank.clock[old_slots],
        "bank:rounds": bank.rounds[old_slots],
    }

    # ---- affinity tables: dense -> canonical columns; store -> the whole
    # store in its old layout (load remaps its columns)
    if eng.store is not None:
        save_population_store(path / "store.npz", eng.store)
    else:
        tbl = pipe.table
        arrays["table:reward"] = tbl.reward[:, old_slots]
        arrays["table:known"] = tbl.known[:, old_slots]
        arrays["table:cluster_idx"] = tbl.cluster_idx[:, old_slots]
        arrays["fp:fingerprint"] = np.asarray(eng.fingerprint)
        arrays["fp:seen"] = np.asarray(eng.fp_seen)
        arrays["fp:neg"] = np.asarray(eng.neg_streak)
        pids = np.fromiter(eng._probe_cache.keys(), np.int64, len(eng._probe_cache))
        arrays["probe:ids"] = pids
        arrays["probe:vals"] = (
            np.stack([eng._probe_cache[int(c)] for c in pids])
            if pids.size
            else np.zeros((0, eng.auxo.d_sketch), np.float32)
        )

    # ---- coordinator: clusterers (state + threefry key data), identities
    co = eng.coordinator
    for cid, cl in co.clusterers.items():
        for f in dataclasses.fields(ClusterState):
            arrays[f"clu:{cid}:{f.name}"] = host_array(getattr(cl.state, f.name))
        arrays[f"clu:{cid}:key"] = host_array(cl._key).astype(np.uint32)
    for cid, ident in co.identity.items():
        arrays[f"ident:{cid}"] = np.asarray(ident, np.float32)

    # ---- engine soft state
    arrays["eng:global_mu"] = np.asarray(eng.global_mu, np.float32)
    for i, h in enumerate(eng.history):
        pc = h.get("per_client")
        if pc is not None:
            arrays[f"hist:{i}:per_client"] = np.asarray(pc)
    if eng.churn is not None:
        arrays["churn:away"] = np.asarray(eng.churn.away, np.int64)

    # ---- the §⑤ staged next-round plan (after the flush: a live plan with
    # its host buffers, an empty-round marker, or nothing)
    staged_meta: Optional[Dict[str, Any]] = None
    if pipe._staged is not None:
        r, plan, _packed = pipe._staged
        if r != next_round:
            raise RuntimeError(f"staged round {r} is not the next round {next_round}")
        staged_meta = {"round": int(r), "has_plan": plan is not None}
        if plan is not None:
            if pipe._staged_host is None:
                raise RuntimeError("staged plan without host buffers")
            for name in _PLAN_ARRAYS:
                arrays[f"plan:{name}"] = np.asarray(getattr(plan, name))
            xs, ys, inv = pipe._staged_host
            arrays["planbuf:xs"] = xs
            arrays["planbuf:ys"] = ys
            arrays["planbuf:inv"] = inv
            staged_meta.update(
                round_idx=int(plan.round_idx),
                leaves=list(plan.leaves),
                active=list(plan.active),
                durations={k: float(v) for k, v in plan.durations.items()},
                key_seed=int(plan.key_seed),
                n_real=int(plan.n_real),
                dropped=int(plan.dropped),
            )

    np.savez(path / "arrays.npz", **arrays)

    spec = eng.data.plane_spec()
    if spec is not None:
        save_data_plane(path / "data_plane.npz", eng.data)

    task = eng.task
    meta = {
        "version": _VERSION,
        "next_round": int(next_round),
        "fl": dataclasses.asdict(eng.fl),
        "auxo": dataclasses.asdict(eng.auxo),
        "task": {
            "module": type(task).__module__,
            "cls": type(task).__qualname__,
            "fields": dataclasses.asdict(task) if dataclasses.is_dataclass(task) else None,
        },
        "has_plane": spec is not None,
        "n_clients": int(eng.data.n_clients),
        "alloc_ids": alloc_ids,
        "old_shards": int(bank.n_shards),
        "old_capacity": int(bank.capacity),
        "exec_width": int(pipe.exec_width),
        "rng_state": eng.rng.bit_generator.state,
        "resource_used": float(eng.resource_used),
        "global_mu_seen": bool(eng.global_mu_seen),
        "fp_beta": float(eng.fp_beta),
        "probe_cache_key": int(eng._probe_cache_key),
        "probe_train_dispatches": int(eng.probe_train_dispatches),
        "pipeline": {
            "exec_dispatches": int(pipe.exec_dispatches),
            "dropped_rows": int(pipe.dropped_rows),
            "flushes": int(pipe.flushes),
        },
        "staged": staged_meta,
        "coordinator": {
            # insertion order matters: tree.leaves() walks the nodes dict,
            # and the leaf order drives every later plan's RNG draws
            "tree": {
                cid: {"parent": n.parent, "children": list(n.children)}
                for cid, n in co.tree.nodes.items()
            },
            "clusterer_ids": list(co.clusterers.keys()),
            "ema": float(next(iter(co.clusterers.values())).ema),
            "identity_ids": list(co.identity.keys()),
            "stats": {cid: dataclasses.asdict(st) for cid, st in co.stats.items()},
            "strikes": {str(k): int(v) for k, v in co.strikes.items()},
            "blacklist": sorted(int(c) for c in co.blacklist),
            "partitions": [
                {
                    "parent": p.parent,
                    "children": list(p.children),
                    "round_idx": int(p.round_idx),
                    "cluster_to_child": {str(k): v for k, v in p.cluster_to_child.items()},
                }
                for p in co.partitions
            ],
        },
        "history": [
            {k: _jsonable(v) for k, v in h.items() if k != "per_client"} for h in eng.history
        ],
        "churn": (
            None
            if eng.churn is None
            else {
                "n_clients": int(eng.churn.n_clients),
                "depart_rate": float(eng.churn.depart_rate),
                "return_rate": float(eng.churn.return_rate),
                "seed": int(eng.churn.seed),
            }
        ),
    }
    with open(path / "meta.json", "w") as f:
        json.dump(_jsonable(meta), f)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------
def load_run(
    path: str | Path,
    cohort_shards: Optional[int] = None,
    population=None,
    task=None,
    *,
    device=None,
    devices=None,
):
    """Rebuild a live engine from a ``save_run`` checkpoint of either package.

    ``cohort_shards`` restores onto another shard count (elastic remesh):
    the bank slots, clocks and affinity columns re-pack into the new
    layout. ``population`` supplies the data plane when the checkpoint
    holds no recipe; ``task`` overrides the recorded task (required for a
    task that is not a dataclass). ``device``/``devices`` place the engine
    as ``AuxoEngine``'s do (None means the card).

    Returns the engine; resume the driver loop at ``engine.round_cursor``.
    """
    from repro_torch.fl.engine import AuxoConfig, AuxoEngine, FLConfig
    from repro_torch.fl.pipeline import MatchPlan

    path = Path(path)
    with open(path / "meta.json") as f:
        meta = json.load(f)
    if meta["version"] != _VERSION:
        raise ValueError(f"checkpoint version {meta['version']}, expected {_VERSION}")
    data = np.load(path / "arrays.npz", allow_pickle=False)

    fl = FLConfig(**meta["fl"])
    if cohort_shards is not None:
        fl.cohort_shards = int(cohort_shards)
    auxo = AuxoConfig(**meta["auxo"])

    staged = meta["staged"]
    if (
        staged is not None
        and staged["has_plan"]
        and max(1, int(fl.cohort_shards or 1)) != meta["old_shards"]
    ):
        raise ValueError(
            "checkpoint holds a staged plan packed for "
            f"cohort_shards={meta['old_shards']}; its buffers are layout-bound and "
            f"cannot restore onto {fl.cohort_shards} shards — save from "
            "round_overlap=0 or at a point with no staged plan to remesh"
        )

    if task is None:
        tmeta = meta["task"]
        cls = getattr(importlib.import_module(_task_module(tmeta["module"])), tmeta["cls"])
        if tmeta["fields"] is None:
            raise ValueError(f"task {tmeta['cls']} is not a dataclass; pass task= to load_run")
        task = cls(**tmeta["fields"])
    if population is None:
        if not meta["has_plane"]:
            raise ValueError(
                "checkpoint holds no data-plane recipe (opaque plane); pass population= to load_run"
            )
        population = load_data_plane(path / "data_plane.npz")

    eng = AuxoEngine(task, population, fl, auxo, device=device, devices=devices)
    if eng.data.n_clients != meta["n_clients"]:
        raise ValueError(f"population has {eng.data.n_clients} clients, the run {meta['n_clients']}")
    pipe = eng.pipeline
    bank = pipe.bank

    # ---- coordinator (tree first: node insertion order drives leaf order)
    co = eng.coordinator
    cmeta = meta["coordinator"]
    for cid, node in cmeta["tree"].items():
        if cid != co.tree.root:
            co.tree.nodes[cid] = CohortNode(cid, node["parent"])
    for cid, node in cmeta["tree"].items():
        co.tree.nodes[cid].children = list(node["children"])
    co.clusterers = {}
    for cid in cmeta["clusterer_ids"]:
        cl = OnlineClustering(co.cluster_k, co.d_sketch, ema=cmeta["ema"], seed=0, device=co.device)
        state = cluster_state_from_numpy(
            device=co.device,
            **{f.name: data[f"clu:{cid}:{f.name}"] for f in dataclasses.fields(ClusterState)},
        )
        cl.state = host_state(state) if co.host_states else state
        cl._key = torch.from_numpy(data[f"clu:{cid}:key"].astype(np.int64)).to(co.device)
        co.clusterers[cid] = cl
    co.identity = {cid: data[f"ident:{cid}"].copy() for cid in cmeta["identity_ids"]}
    co.stats = {cid: CohortStats(**st) for cid, st in cmeta["stats"].items()}
    co.strikes = {int(k): v for k, v in cmeta["strikes"].items()}
    co.blacklist = set(cmeta["blacklist"])
    co.partitions = [
        PartitionEvent(
            parent=p["parent"],
            children=list(p["children"]),
            round_idx=p["round_idx"],
            cluster_to_child={int(k): v for k, v in p["cluster_to_child"].items()},
        )
        for p in cmeta["partitions"]
    ]

    # ---- bank: scatter the allocation-order state into THIS layout's slots
    # (the remesh re-pack; the identity when the shard counts match)
    alloc_ids = meta["alloc_ids"]
    A = len(alloc_ids)
    if A > bank.capacity:
        raise ValueError(f"{A} cohorts do not fit the bank's {bank.capacity} slots")
    old_slots = alloc_slots(A, meta["old_capacity"], meta["old_shards"])
    new_slots = alloc_slots(A, bank.capacity, bank.n_shards)
    bank.slot_of = {cid: int(new_slots[n]) for n, cid in enumerate(alloc_ids)}
    bank.id_of = {s: cid for cid, s in bank.slot_of.items()}
    bank._next = A

    def canonical(name, tree):
        like = tree_map(lambda a: torch.empty((A,) + tuple(a.shape[1:]), dtype=a.dtype), tree)
        return load_pytree(path / name, like)

    bank.params = scatter_allocations(bank.params, canonical("bank_params.npz", bank.params), new_slots)
    bank.opt_state = scatter_allocations(
        bank.opt_state, canonical("bank_opt.npz", bank.opt_state), new_slots
    )
    bank.clock[new_slots] = data["bank:clock"]
    bank.rounds[new_slots] = data["bank:rounds"]

    # ---- affinity tables + client soft state
    if eng.store is not None:
        loaded = load_population_store(path / "store.npz")
        remap_affinity_slots(loaded, old_slots, new_slots, bank.capacity)
        # mutate the engine's store IN PLACE: the table, field and cache
        # views built by the engine hold references to this object
        adopt_store_state(eng.store, loaded)
    else:
        tbl = pipe.table
        tbl.reward[:, new_slots] = data["table:reward"]
        tbl.known[:, new_slots] = data["table:known"]
        tbl.cluster_idx[:, new_slots] = data["table:cluster_idx"]
        eng.fingerprint = data["fp:fingerprint"].copy()
        eng.fp_seen = data["fp:seen"].copy()
        eng.neg_streak = data["fp:neg"].copy()
        pids = data["probe:ids"]
        if pids.size:
            eng._probe_cache.put(pids, data["probe:vals"].copy())

    # ---- engine scalars
    eng.global_mu = data["eng:global_mu"].copy()
    eng.global_mu_seen = meta["global_mu_seen"]
    eng.fp_beta = meta["fp_beta"]
    eng.resource_used = meta["resource_used"]
    eng._probe_cache_key = meta["probe_cache_key"]
    eng.probe_train_dispatches = meta["probe_train_dispatches"]
    eng.round_cursor = meta["next_round"]
    eng.history = []
    for i, h in enumerate(meta["history"]):
        h = dict(h)
        k = f"hist:{i}:per_client"
        if k in data:
            h["per_client"] = data[k].copy()
        eng.history.append(h)
    if meta["churn"] is not None:
        cs = ChurnStream(**meta["churn"])
        cs._away = data["churn:away"].copy()
        eng.churn = cs
    # the host RNG resumes exactly where the saved run left it (after any
    # draws the engine's construction made above)
    eng.rng.bit_generator.state = meta["rng_state"]

    # ---- pipeline: counters + the staged next round
    pipe.exec_dispatches = meta["pipeline"]["exec_dispatches"]
    pipe.dropped_rows = meta["pipeline"]["dropped_rows"]
    pipe.flushes = meta["pipeline"]["flushes"]
    if staged is not None:
        if staged["has_plan"]:
            if pipe.exec_width != meta["exec_width"]:
                raise ValueError(f"row width {pipe.exec_width}, the staged plan's {meta['exec_width']}")
            plan = MatchPlan(
                round_idx=staged["round_idx"],
                leaves=list(staged["leaves"]),
                active=list(staged["active"]),
                durations=dict(staged["durations"]),
                key_seed=staged["key_seed"],
                n_real=staged["n_real"],
                dropped=staged["dropped"],
                **{name: data[f"plan:{name}"].copy() for name in _PLAN_ARRAYS},
            )
            xs = data["planbuf:xs"].copy()
            ys = data["planbuf:ys"].copy()
            inv = data["planbuf:inv"].copy()
            pipe._staged = (staged["round"], plan, pipe._stage_buffers(plan, xs, ys, inv))
            pipe._staged_host = (xs, ys, inv)
        else:
            pipe._staged = (staged["round"], None, None)
    # republish the serving snapshot from the restored bank (§⑧)
    pipe._serve = bank.group_params
    return eng
