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
(``bank_spec``/``bank_shardings``), each slot's leaf by the parameter
policies over a ``model`` axis, and the round's flat row axis over
``cohort`` (``row_sharding``). Here a placement is explicit: shard j owns
the slot block ``[j*slots_per_shard, (j+1)*slots_per_shard)`` and the row
block ``[j*shard_width, (j+1)*shard_width)``, and the shards whose model
positions sit on the same devices form a ``ShardGroup`` whose blocks are
stacked in one tensor a position there (``bank_placement``/
``row_placement`` give each group's slot and row ids in that stacked
order). ``bank_shardings`` gives each stacked leaf a ``CohortSharding``
(the reference's ``NamedSharding`` of its ``bank_spec``); a leaf held in
its pieces is a ``Placed``: one local piece a group and model position,
on that position's device, split along the dim the spec gives ``model``
(whole where it replicates).

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



# ---------------------------------------------------------------------------
# CohortBank placement: slot axis -> cohort shards, a slot's dims -> model
# ---------------------------------------------------------------------------
def bank_spec(keystr: str, shape: Tuple[int, ...], mesh, policy: str = "dp") -> Spec:
    """Spec of one stacked CohortBank leaf: ``shape[0]`` is the slot axis
    (``cohort``), ``shape[1:]`` one cohort model's leaf, split within the
    slot by ``param_spec`` when the mesh has a ``model`` axis and the
    policy is not ``dp``. Trailing ``None``s are stripped, as the
    reference strips them."""
    if len(shape) == 0:
        return ()
    inner: Tuple = ()
    if policy != "dp" and "model" in axis_sizes(mesh) and len(shape) > 1:
        inner = param_spec(keystr, tuple(shape[1:]), mesh, policy)
    while inner and inner[-1] is None:
        inner = inner[:-1]
    return ("cohort",) + tuple(inner)


class CohortSharding(NamedTuple):
    """Where a stacked tensor lives on a cohort mesh (the reference's
    ``NamedSharding(mesh, spec)``): the leading axis over the cohort
    shards, the dim that ``spec`` gives ``model`` split over each shard's
    model positions."""
    mesh: Any
    spec: Spec

    @property
    def split_dim(self) -> Optional[int]:
        return next((d for d, e in enumerate(self.spec) if e == "model"), None)


def _checked(mesh, spec: Spec) -> CohortSharding:
    """A ``CohortSharding``; raises ValueError, as the reference's
    ``NamedSharding`` does, when ``spec`` names an axis the mesh lacks."""
    axes = axis_sizes(mesh)
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and a not in axes:
                raise ValueError(f"Resource axis: {a} of {spec} is not found in mesh: {tuple(axes)}")
    return CohortSharding(mesh, tuple(spec))


def bank_shardings(shapes: Any, mesh, policy: str = "dp"):
    """A stacked bank tree (leaves ``(capacity, ...)``, real or meta) -> a
    tree of ``CohortSharding``: slot axis over ``cohort``, a slot's dims by
    ``policy``."""
    return tree_map_with_path(
        lambda path, leaf: _checked(mesh, bank_spec(path, tuple(leaf.shape), mesh, policy)), shapes
    )


def row_sharding(mesh) -> CohortSharding:
    """The round's flat participant-row axis over ``cohort``: rows live on
    the shard that owns their cohort's bank slot."""
    return CohortSharding(mesh, ("cohort",))


class ShardGroup(NamedTuple):
    device: torch.device  # the device of the shards' first model position
    shards: Tuple[int, ...]  # the cohort shards on these devices, ascending


def shard_groups(mesh) -> List[ShardGroup]:
    """The mesh's cohort shards grouped by the devices of their model
    positions, in order of each group's first shard."""
    order: List[Tuple[torch.device, ...]] = []
    by_devs = {}
    for j in range(mesh.n_shards):
        devs = mesh.shard_devices(j)
        if devs not in by_devs:
            order.append(devs)
            by_devs[devs] = []
        by_devs[devs].append(j)
    return [ShardGroup(d[0], tuple(by_devs[d])) for d in order]


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


class Placed(NamedTuple):
    """A stacked (capacity, ...) tensor held in the pieces of ``sharding``:
    ``parts[g][m]`` holds group g's slots (``bank_placement`` order) at
    model position m, on that position's device, split along
    ``sharding.split_dim`` or whole where the spec replicates."""
    sharding: CohortSharding
    parts: Tuple[Tuple[torch.Tensor, ...], ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        mesh, d = self.sharding.mesh, self.sharding.split_dim
        shape = list(self.parts[0][0].shape)
        shape[0] = sum(p[0].shape[0] for p in self.parts)
        if d is not None:
            shape[d] *= mesh.model
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0][0].device

    def shard_shapes(self) -> List[Tuple[int, ...]]:
        """The local shape at every mesh position, shard-major (the
        reference's ``addressable_shards`` shapes)."""
        mesh = self.sharding.mesh
        sps = self.shape[0] // mesh.n_shards
        groups = shard_groups(mesh)
        return [(sps,) + tuple(p.shape[1:]) for j in range(mesh.n_shards)
                for p in self.parts[next(g for g, gr in enumerate(groups) if j in gr.shards)]]

    def slot(self, g: int, row: int, device=None) -> torch.Tensor:
        """Slot ``row`` of group g, assembled whole on ``device`` (default:
        its first position's)."""
        d = self.sharding.split_dim
        pieces = self.parts[g]
        device = pieces[0].device if device is None else device
        if d is None:
            return pieces[0][row].to(device)
        return torch.cat([p[row].to(device) for p in pieces], dim=d - 1)

    def whole(self, device=None) -> torch.Tensor:
        """The (capacity, ...) tensor, assembled in slot order on ``device``."""
        mesh, d = self.sharding.mesh, self.sharding.split_dim
        device = self.device if device is None else device
        groups = shard_groups(mesh)
        sps = self.shape[0] // mesh.n_shards
        blocks = []
        for j in range(mesh.n_shards):
            g = next(i for i, gr in enumerate(groups) if j in gr.shards)
            pos = groups[g].shards.index(j)
            rows = [p[pos * sps:(pos + 1) * sps].to(device) for p in self.parts[g]]
            blocks.append(rows[0] if d is None else torch.cat(rows, dim=d))
        return torch.cat(blocks)

    def copy_rows(self, g_src: int, row: int, dst) -> "Placed":
        """A copy with slot ``row`` of group ``g_src`` written to the rows
        ``dst[g]`` of every group g in ``dst``, piece by piece: position m's
        piece goes to position m's pieces only. Out of place."""
        src = [p[row] for p in self.parts[g_src]]
        parts = []
        for g, grp in enumerate(self.parts):
            rows = dst.get(g)
            if not rows:
                parts.append(grp)
                continue
            new = []
            for p, s in zip(grp, src):
                out = p.clone()
                out[rows] = s.to(p.device)
                new.append(out)
            parts.append(tuple(new))
        return Placed(self.sharding, tuple(parts))


def _piece(block: torch.Tensor, d: Optional[int], m: int, n_model: int, device) -> torch.Tensor:
    """Position m's piece of ``block``, a copy of its own on ``device``."""
    if d is not None:
        size = block.shape[d] // n_model
        block = block.narrow(d, m * size, size)
    return torch.empty(block.shape, dtype=block.dtype, device=device).copy_(block)


def place(a: torch.Tensor, sharding: CohortSharding) -> Placed:
    """``a`` (capacity, ...) split into the pieces of ``sharding``: each
    group's slot rows, each model position's piece on its device."""
    mesh, d = sharding.mesh, sharding.split_dim
    groups = shard_groups(mesh)
    rows = bank_placement(groups, a.shape[0] // mesh.n_shards)
    parts = []
    for gr, r in zip(groups, rows):
        block = a[torch.as_tensor(r, device=a.device)]
        devs = mesh.shard_devices(gr.shards[0])
        parts.append(tuple(_piece(block, d, m, mesh.model, dv) for m, dv in enumerate(devs)))
    return Placed(sharding, tuple(parts))


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
    if isinstance(a, Placed):
        a = a.whole("cpu")
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def gather_allocations(tree: Any, old_slots: np.ndarray) -> Any:
    """Canonical per-allocation view of a stacked (capacity, ...) tree:
    ``leaf[old_slots]`` as host numpy arrays (allocation order)."""
    idx = np.asarray(old_slots, np.int64)
    return tree_map(lambda a: _np(a)[idx], tree)


def _stacked(write, out_shardings, *trees):
    """``write`` over the trees' leaves, each result placed in its
    sharding's pieces at once when ``out_shardings`` is given (one whole
    leaf at a time)."""
    if out_shardings is None:
        return tree_map(write, *trees)
    return tree_map(lambda sh, *a: place(write(*a), sh), out_shardings, *trees)


def scatter_allocations(tree: Any, canonical: Any, new_slots, out_shardings=None) -> Any:
    """A copy of the stacked tree with the canonical per-allocation leaves
    written at ``new_slots`` (out of place, on each leaf's device). With
    ``out_shardings`` (a ``bank_shardings`` tree) every leaf lands in its
    sharding's pieces (a ``Placed``), as a bank of that placement holds it."""
    idx = torch.as_tensor(np.asarray(new_slots, np.int64))

    def write(a, v):
        out = a.whole() if isinstance(a, Placed) else torch.as_tensor(a).clone()
        out[idx.to(out.device)] = torch.as_tensor(v).to(device=out.device, dtype=out.dtype)
        return out

    return _stacked(write, out_shardings, tree, canonical)


def repack_stacked(
    tree: Any, capacity: int, n_alloc: int, old_shards: int, new_shards: int, out_shardings=None
) -> Any:
    """Re-pack a stacked (old padded capacity, ...) tree into the slot layout
    of ``new_shards``, on each leaf's device: the live allocations move from
    their old slots to their new ones; slots no allocation maps to hold
    zeros, as a freshly built bank's unallocated slots do.
    ``out_shardings``: as in ``scatter_allocations``."""
    old_slots, new_slots = repack_permutation(n_alloc, capacity, old_shards, new_shards)
    new_cap = padded_capacity(capacity, new_shards)
    old_idx, new_idx = (torch.as_tensor(np.asarray(i, np.int64)) for i in (old_slots, new_slots))

    def write(a):
        a = a.whole() if isinstance(a, Placed) else torch.as_tensor(a)
        out = torch.zeros((new_cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        out[new_idx.to(a.device)] = a[old_idx.to(a.device)]
        return out

    return _stacked(write, out_shardings, tree)


__all__ = [
    "CohortSharding",
    "Placed",
    "ShardGroup",
    "alloc_slots",
    "bank_placement",
    "bank_shardings",
    "bank_spec",
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
    "place",
    "placements",
    "replicated",
    "gather_allocations",
    "padded_capacity",
    "repack_permutation",
    "repack_stacked",
    "row_placement",
    "row_sharding",
    "scatter_allocations",
    "shard_groups",
]
