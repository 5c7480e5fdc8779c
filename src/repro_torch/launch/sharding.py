"""Placement of the CohortBank over a cohort mesh and the elastic remesh's
slot algebra (port of the bank half of ``repro.launch.sharding``).

The reference shards the bank's slot axis over a ``cohort`` mesh axis
(``bank_spec``/``bank_shardings``) and the round's flat row axis likewise
(``row_sharding``). Here a placement is explicit: shard j owns the slot
block ``[j*slots_per_shard, (j+1)*slots_per_shard)`` and the row block
``[j*shard_width, (j+1)*shard_width)``, and the shards that sit on one
device form a ``ShardGroup`` whose blocks are stacked in one tensor there
(``bank_placement``/``row_placement`` give each group's slot and row ids
in that stacked order).

Remesh (ARCHITECTURE.md §⑨): the bank allocates slot n -> (n % S) *
slots_per_shard + n // S, so a cohort's slot id depends on the shard
count; the layout-free key is the allocation index (0 = root, then
partition order). ``alloc_slots`` maps allocation order to slots;
``gather_allocations``/``scatter_allocations``/``repack_stacked`` move
stacked per-slot state between layouts.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


class ShardGroup(NamedTuple):
    device: torch.device
    shards: Tuple[int, ...]  # the mesh positions on this device, ascending


def shard_groups(mesh) -> List[ShardGroup]:
    """The mesh's shards grouped by device, in order of each device's first
    shard."""
    order: List[torch.device] = []
    by_dev = {}
    for j, d in enumerate(mesh.devices):
        if d not in by_dev:
            order.append(d)
            by_dev[d] = []
        by_dev[d].append(j)
    return [ShardGroup(d, tuple(by_dev[d])) for d in order]


def _blocks(group: ShardGroup, block: int) -> np.ndarray:
    return np.concatenate(
        [np.arange(j * block, (j + 1) * block, dtype=np.int64) for j in group.shards]
    )


def bank_placement(groups: List[ShardGroup], slots_per_shard: int) -> List[np.ndarray]:
    """Each group's bank slot ids, in the order its stacked tensor holds them."""
    return [_blocks(g, slots_per_shard) for g in groups]


def row_placement(groups: List[ShardGroup], shard_width: int) -> List[np.ndarray]:
    """Each group's flat round rows, in the order its stacked buffers hold them."""
    return [_blocks(g, shard_width) for g in groups]


# ---------------------------------------------------------------------------
# Elastic remesh: re-pack bank slots to a new shard count
# ---------------------------------------------------------------------------
def padded_capacity(capacity: int, n_shards: int) -> int:
    """Bank capacity after shard padding (every shard owns an equal block)."""
    n_shards = max(1, int(n_shards))
    return -(-int(capacity) // n_shards) * n_shards


def alloc_slots(n_alloc: int, capacity: int, n_shards: int) -> np.ndarray:
    """Slot ids of allocations 0..n_alloc-1 under the bank's round-robin
    placement (``CohortBank._alloc_slot`` after shard padding). Idempotent
    in ``capacity``: padding an already-padded capacity is a no-op."""
    n_shards = max(1, int(n_shards))
    cap = padded_capacity(capacity, n_shards)
    if n_alloc > cap:
        raise ValueError(f"{n_alloc} allocations exceed the padded capacity {cap}")
    n = np.arange(int(n_alloc), dtype=np.int64)
    if n_shards == 1:
        return n
    sps = cap // n_shards
    return (n % n_shards) * sps + n // n_shards


def repack_permutation(
    n_alloc: int, capacity: int, old_shards: int, new_shards: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(old_slots, new_slots): where allocation n lived under ``old_shards``
    and where it lands under ``new_shards``; both injective."""
    return (
        alloc_slots(n_alloc, capacity, old_shards),
        alloc_slots(n_alloc, capacity, new_shards),
    )


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def gather_allocations(tree: Any, old_slots: np.ndarray) -> Any:
    """Canonical per-allocation view of a stacked (capacity, ...) tree:
    ``leaf[old_slots]`` as host numpy arrays (allocation order)."""
    idx = np.asarray(old_slots, np.int64)
    return tree_map(lambda a: _np(a)[idx], tree)


def scatter_allocations(tree: Any, canonical: Any, new_slots) -> Any:
    """A copy of the stacked tree with the canonical per-allocation leaves
    written at ``new_slots`` (out of place, on each leaf's device)."""
    idx = torch.as_tensor(np.asarray(new_slots, np.int64))

    def put(a, v):
        a = torch.as_tensor(a)
        out = a.clone()
        out[idx.to(a.device)] = torch.as_tensor(v).to(device=a.device, dtype=a.dtype)
        return out

    return tree_map(put, tree, canonical)


def repack_stacked(
    tree: Any, capacity: int, n_alloc: int, old_shards: int, new_shards: int
) -> Any:
    """Re-pack a stacked (old padded capacity, ...) tree into the slot layout
    of ``new_shards``; slots no allocation maps to hold zeros, as a freshly
    built bank's unallocated slots do."""
    old_slots, new_slots = repack_permutation(n_alloc, capacity, old_shards, new_shards)
    canonical = gather_allocations(tree, old_slots)
    new_cap = padded_capacity(capacity, new_shards)
    target = tree_map(
        lambda a: torch.zeros((new_cap,) + tuple(a.shape[1:]), dtype=torch.as_tensor(a).dtype,
                              device=torch.as_tensor(a).device),
        tree,
    )
    return scatter_allocations(target, canonical, new_slots)


__all__ = [
    "ShardGroup",
    "alloc_slots",
    "bank_placement",
    "gather_allocations",
    "padded_capacity",
    "repack_permutation",
    "repack_stacked",
    "row_placement",
    "scatter_allocations",
    "shard_groups",
]
