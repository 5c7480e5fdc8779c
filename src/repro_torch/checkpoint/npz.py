"""Flat-keyed ``.npz`` checkpoints (port of ``repro.checkpoint.npz``).

``save_pytree``/``load_pytree``: param and optimizer trees, each leaf
stored under its JAX key path (``"['backbone']['blocks']['mlp']['wg']"``),
so a file written by either package loads into the other. npz has no
bfloat16: such leaves are stored bit for bit as uint16 and viewed back on
load. ``save_population_store``/``load_population_store``: the §⑥ chunked
store, its materialized chunks stacked per field plus the per-chunk owner
maps (the paged id→row index is rebuilt on load). ``save_data_plane``/
``load_data_plane``: the data plane as its generation recipe, never as
client arrays. The files are the JAX package's, key for key.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.data.datasets import make_population
from repro_torch.data.plane import DataPlane, MaterializedDataPlane, ProceduralDataPlane
from repro_torch.scale.store import FieldSpec, PopulationStore
from repro_torch.utils.tree import leaves_with_path, tree_map


def _encode(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_pytree(path: str | Path, tree: Any):
    np.savez(path, **{k: _encode(v) for k, v in leaves_with_path(tree)})


def load_pytree(path: str | Path, like: Any) -> Any:
    """Restore into the structure of ``like`` (keys must match); dtypes and
    devices come from ``like``, so bfloat16 leaves restore bit-exactly."""
    data = np.load(path, allow_pickle=False)
    by_leaf = {}
    for k, leaf in leaves_with_path(like):
        if k not in data:
            raise KeyError(f"checkpoint missing {k}")
        arr = data[k]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {tuple(leaf.shape)}")
        if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr)).to(leaf.dtype)
        by_leaf[id(leaf)] = t.to(leaf.device)
    return tree_map(lambda leaf: by_leaf[id(leaf)], like)


def save_data_plane(path: str | Path, plane: DataPlane):
    """Checkpoint a DataPlane as its spec (a recipe, not arrays). Raises for
    a plane without one (hand-built arrays): its owner persists those."""
    spec = plane.plane_spec()
    if spec is None:
        raise ValueError(
            f"{type(plane).__name__} holds opaque data (no generation "
            "spec); persist the underlying arrays yourself"
        )
    np.savez(path, **{f"spec:{k}": np.asarray(v) for k, v in spec.items()})


def load_data_plane(path: str | Path) -> DataPlane:
    """Rebuild a DataPlane from its spec (both kinds regenerate bit for bit
    from the seed)."""
    data = np.load(path, allow_pickle=False)
    spec = {k[len("spec:"):]: data[k][()] for k in data.files if k.startswith("spec:")}
    kind = str(spec.pop("kind"))
    spec = {k: v.item() for k, v in spec.items()}
    if kind == "procedural":
        return ProceduralDataPlane(**spec)
    if kind == "materialized":
        return MaterializedDataPlane(make_population(**spec))
    raise ValueError(f"unknown data-plane kind {kind!r}")


def save_population_store(path: str | Path, store: PopulationStore):
    """Checkpoint a chunked PopulationStore: chunk arrays + id index."""
    arrays = {
        "meta:scalars": np.array(
            [store.n_base, store.n_total, store.n_rows, store.chunk_rows, store.n_departed],
            np.int64,
        ),
        "meta:owner": (
            np.stack(store._owner) if store._owner else np.zeros((0, store.chunk_rows), np.int64)
        ),
    }
    for name in store.field_names:
        f = store.spec(name)
        chunks = store.chunks(name)
        arrays[f"chunk:{name}"] = (
            np.stack(chunks) if chunks else np.zeros((0, store.chunk_rows) + f.shape, f.dtype)
        )
        arrays[f"default:{name}"] = np.asarray(f.default, f.dtype)
    np.savez(path, **arrays)


def load_population_store(path: str | Path) -> PopulationStore:
    """Restore a PopulationStore; the paged id→row index is rebuilt from the
    per-chunk owner maps (rows keep their exact allocation order)."""
    data = np.load(path, allow_pickle=False)
    n_base, n_total, n_rows, chunk_rows, n_departed = data["meta:scalars"]
    fields = []
    for key in data.files:
        if not key.startswith("chunk:"):
            continue
        name = key[len("chunk:"):]
        arr = data[key]
        fields.append(FieldSpec(name, tuple(arr.shape[2:]), arr.dtype, data[f"default:{name}"][()]))
    store = PopulationStore(fields, n_clients=int(n_base), chunk_rows=int(chunk_rows))
    store.n_total = int(n_total)
    store.n_rows = int(n_rows)
    store.n_departed = int(n_departed)
    owner = data["meta:owner"]
    store._owner = [owner[c].copy() for c in range(owner.shape[0])]
    for f in fields:
        arr = data[f"chunk:{f.name}"]
        store._chunks[f.name] = [arr[c].copy() for c in range(arr.shape[0])]
    for c, own in enumerate(store._owner):  # rebuild the paged index
        m = own >= 0
        ids = own[m]
        rows = c * store.chunk_rows + np.flatnonzero(m)
        pg = ids >> store.PAGE_BITS
        off = ids & ((1 << store.PAGE_BITS) - 1)
        for p in np.unique(pg):
            page = store._pages.setdefault(int(p), np.full(1 << store.PAGE_BITS, -1, np.int32))
            sel = pg == p
            page[off[sel]] = rows[sel]
    return store
