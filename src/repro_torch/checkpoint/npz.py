"""Flat-keyed ``.npz`` checkpoints of param trees (port of
``repro.checkpoint.npz.save_pytree`` / ``load_pytree``).

Each leaf is stored under its JAX key path (``"['backbone']['blocks']['mlp']['wg']"``),
so a file written by either package loads into the other. npz has no
bfloat16: such leaves are stored bit for bit as uint16 and viewed back on
load.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

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
