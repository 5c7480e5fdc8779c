"""Sharding rules (port of ``repro.launch.sharding``).

Parameter policies, as in the reference:

- ``tp``   weights sharded over ``model`` only (heads / ffn / vocab /
           experts), replicated over the data axes;
- ``fsdp`` ``tp`` plus the largest remaining divisible axis sharded over
           the data axes (ZeRO-3): the two big MoE configs;
- ``ep``   expert tensors shard E over the data axes and F/D over
           ``model``; the others follow ``tp``;
- ``dp``   weights replicated; batches may shard the sequence over
           ``model`` (``batch_shardings(seq_shard=True)``).

A spec is a tuple with one entry per tensor dim: ``None``, an axis name, or
a tuple of axis names (the reference's ``PartitionSpec`` spelled as a
tuple, entry for entry; ``()`` is fully replicated). ``param_shardings``,
``batch_shardings`` and ``cache_shardings`` turn specs into DTensor
placements, one per mesh dim: ``Shard(d)`` where the dim's axis name
appears in entry d (``("pod", "data")`` on dim d is ``Shard(d)`` on both,
in that order), else ``Replicate()``. ``per_card_bytes`` is the exact
per-card size of a tree under a policy (specs shard divisible dims only).

The FL engine's half:

Placement of the CohortBank over a cohort mesh and the elastic remesh's
slot algebra (the bank half of ``repro.launch.sharding``).

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

import math
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import axis_sizes, data_axes, data_size, model_size
from repro_torch.utils import spmd
from repro_torch.utils.tree import leaves_with_path, tree_map, tree_map_with_path

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# Parameter, batch and cache specs
# ---------------------------------------------------------------------------
# path fragments whose leaves get this many leading stacked-layer axes
_STACK2 = ("'mamba'", "'mlstm'")
_STACK1 = (
    "'blocks'",
    "'dense_blocks'",
    "'moe_blocks'",
    "'mamba_tail'",
    "'slstm'",
)

# preferred model-sharded dim (negative index into the unstacked shape),
# first divisible one wins; positive names checked in order
_MODEL_RULES = (
    ("'heads'", (-1,)),  # musicgen heads (nc, D, V): V
    ("'embed'", (-2,)),  # (V, D) / (nc, V, D): V
    ("'head'", (-1,)),  # (D, V): V
    ("'wq'", (-2, 0)),
    # never wk/wv on head_dim (RoPE splits hd in half): KV heads if
    # divisible, else the d_model contraction dim
    ("'wk'", (-2, 0)),
    ("'wv'", (-2, 0)),
    ("'wo'", (0, -1)),  # (H, hd, D)
    ("'router'", ()),  # replicate router
    ("'wg'", (0, -1)),  # moe experts (E,D,F): E; dense mlp (D,F): F
    ("'wu'", (0, -1)),
    ("'wd'", (0,)),  # (F,D) or (E,F,D): F / E
    ("'w_in'", (-1, 0)),
    ("'conv_w'", (-1,)),
    ("'w_out'", (0,)),
    ("'w_up'", (-1, 0)),
    ("'w_down'", (0,)),
    ("'w_gates'", ()),
    ("'ffn_up'", (-1, 0)),
    ("'ffn_down'", (0,)),
    ("'r'", ()),
    ("'vis_proj'", (-1,)),
)


def _stack_ndims(keystr: str) -> int:
    if any(f in keystr for f in _STACK2):
        return 2
    if any(f in keystr for f in _STACK1):
        return 1
    return 0


def _moe_expert_leaf(keystr: str) -> bool:
    return "'moe'" in keystr and any(w in keystr for w in ("'wg'", "'wu'", "'wd'"))


def param_spec(keystr: str, shape: Tuple[int, ...], mesh, policy: str) -> Spec:
    """Spec of one parameter leaf (``keystr``: its JAX key path)."""
    if policy == "dp":
        return ()  # fully replicated weights
    msize = model_size(mesh)
    daxes = data_axes(mesh)
    dsize = data_size(mesh)

    stack = min(_stack_ndims(keystr), max(len(shape) - 1, 0))
    body = shape[stack:]
    spec: list = [None] * len(shape)

    # ---- model axis
    model_dim: Optional[int] = None
    candidates: Tuple[int, ...] = ()
    for name, dims in _MODEL_RULES:
        if name in keystr:
            candidates = dims
            break
    if _moe_expert_leaf(keystr):
        candidates = (0,)  # expert-parallel over E
        if policy == "ep":
            # serving EP: E over the data axes, F/D over model
            daxis = daxes if len(daxes) > 1 else daxes[0]
            especs = [None] * len(shape)
            if body[0] % dsize == 0 and body[0] >= dsize:
                especs[stack + 0] = daxis
            for di in (2, 1):
                if di < len(body) and body[di] % msize == 0 and body[di] >= msize:
                    especs[stack + di] = "model"
                    break
            return tuple(especs)
    for d in candidates:
        di = d if d >= 0 else len(body) + d
        if 0 <= di < len(body) and body[di] % msize == 0 and body[di] >= msize:
            model_dim = di
            break
    if model_dim is None and not candidates == () and len(body) > 0:
        # fallback: largest divisible dim, scanned from the end
        order = sorted(range(len(body)), key=lambda i: (-body[i],))
        for di in order:
            if body[di] % msize == 0 and body[di] >= msize * 8:
                model_dim = di
                break
    if model_dim is not None:
        spec[stack + model_dim] = "model"

    # ---- fsdp: shard one more axis over the data axes
    if policy == "fsdp" and len(body) > 0:
        order = sorted(range(len(body)), key=lambda i: (-body[i],))
        for di in order:
            if spec[stack + di] is not None:
                continue
            if body[di] % dsize == 0 and body[di] >= dsize:
                spec[stack + di] = daxes if len(daxes) > 1 else daxes[0]
                break

    return tuple(spec)


def batch_spec(shape: Tuple[int, ...], mesh, batch_dim: int = 0) -> Spec:
    """Shard the leading (client/batch) dim over the data axes."""
    daxes = data_axes(mesh)
    dsize = data_size(mesh)
    spec: list = [None] * len(shape)
    if shape and shape[batch_dim] % dsize == 0 and shape[batch_dim] >= dsize:
        spec[batch_dim] = daxes if len(daxes) > 1 else daxes[0]
    return tuple(spec)


def batch_leaf_spec(shape, dtype, mesh, seq_shard: bool) -> Spec:
    """seq_shard: also shard the SEQUENCE axis over ``model`` (the last axis
    of tokens, the second-to-last of embeddings)."""
    msize = model_size(mesh)
    spec = list(batch_spec(tuple(shape), mesh))
    if seq_shard:
        sdim = len(shape) - 1
        if dtype not in (torch.int32, torch.int64):  # embeddings: (..., P, D)
            sdim = len(shape) - 2
        if sdim > 0 and spec[sdim] is None and shape[sdim] % msize == 0 and shape[sdim] >= msize:
            spec[sdim] = "model"
    return tuple(spec)


def cache_spec(shape: Tuple[int, ...], global_batch: int, mesh, seq_shard: bool = False) -> Spec:
    """KV/recurrent cache leaf: batch dim -> data axes, then one more
    divisible dim -> model.

    seq_shard=False: prefer the trailing head dims for ``model``.
    seq_shard=True: prefer the LARGEST divisible dim (for KV caches the
    sequence axis: flash-decode-style partial attention instead of
    gathering the cache when kv_heads < model size).
    """
    daxes = data_axes(mesh)
    dsize = data_size(mesh)
    msize = model_size(mesh)
    spec: list = [None] * len(shape)
    # stacked caches have 1-2 leading layer dims; find the batch dim by
    # value match instead of position
    bdim = None
    for i, s in enumerate(shape):
        if s == global_batch and global_batch % dsize == 0 and global_batch >= dsize:
            bdim = i
            spec[i] = daxes if len(daxes) > 1 else daxes[0]
            break
    order = (
        sorted(range(len(shape)), key=lambda i: -shape[i])
        if seq_shard
        else list(range(len(shape) - 1, -1, -1))
    )
    for i in order:
        if i == bdim or spec[i] is not None:
            continue
        if shape[i] % msize == 0 and shape[i] >= msize:
            spec[i] = "model"
            break
    if bdim is None:
        # batch-1 decode: give the data axes to the largest remaining dim
        for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
            if spec[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize * 8:
                spec[i] = daxes if len(daxes) > 1 else daxes[0]
                break
    return tuple(spec)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def param_shardings(shapes: Any, mesh, policy: str = "tp"):
    """A parameter tree (meta or real) -> a tree of DTensor placements."""
    return tree_map_with_path(
        lambda path, leaf: placements(param_spec(path, tuple(leaf.shape), mesh, policy), mesh), shapes
    )


def batch_shardings(shapes: Any, mesh, seq_shard: bool = False):
    """A batch tree (tensors or ShapeDtype records) -> DTensor placements."""
    return tree_map(
        lambda l: placements(batch_leaf_spec(tuple(l.shape), l.dtype, mesh, seq_shard), mesh), shapes
    )


def cache_shardings(shapes: Any, global_batch: int, mesh, seq_shard: bool = False):
    return tree_map(
        lambda l: placements(cache_spec(tuple(l.shape), global_batch, mesh, seq_shard), mesh), shapes
    )


def replicated(mesh) -> list:
    return placements((), mesh)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One card's shard of a ``shape`` tensor under ``spec`` (specs shard
    divisible dims only, so every card holds the same shape)."""
    sizes = tuple(axis_sizes(mesh).values())
    return spmd.block(shape, placements(spec, mesh), sizes, (0,) * len(sizes)).local_shape


def per_card_bytes(tree: Any, mesh, policy: str) -> int:
    """Bytes one card holds of a parameter-shaped tree under ``policy``."""
    return sum(
        math.prod(local_shape(tuple(leaf.shape), param_spec(path, tuple(leaf.shape), mesh, policy), mesh))
        * leaf.element_size()
        for path, leaf in leaves_with_path(tree)
    )


def cache_bytes(tree: Any, global_batch: int, mesh, seq_shard: bool = False) -> int:
    """Bytes one card holds of a decode-cache tree under ``cache_spec``."""
    return sum(
        math.prod(local_shape(tuple(leaf.shape), cache_spec(tuple(leaf.shape), global_batch, mesh,
                                                            seq_shard), mesh))
        * leaf.element_size()
        for _, leaf in leaves_with_path(tree)
    )



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
    "batch_leaf_spec",
    "batch_shardings",
    "batch_spec",
    "cache_bytes",
    "cache_shardings",
    "cache_spec",
    "local_shape",
    "param_shardings",
    "param_spec",
    "per_card_bytes",
    "placements",
    "replicated",
    "gather_allocations",
    "padded_capacity",
    "repack_permutation",
    "repack_stacked",
    "row_placement",
    "scatter_allocations",
    "shard_groups",
]
