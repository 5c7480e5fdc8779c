"""Arithmetic over parameter trees: (possibly nested) dicts of tensors.

Code that walks leaves in order (sketches, DP noise keys, the stage-②
flattening, checkpoints) sorts the keys at every level: that is JAX's
flattening order for dicts, so both packages agree. ``leaves_with_path``
names each leaf by its JAX key path (``"['backbone']['blocks']['mlp']['wg']"``),
the string ``jax.tree_util.keystr`` gives it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Tree = Dict[str, Any]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure: nested dicts (keys
    in sorted order, JAX's) and lists (in order). The one walker of the
    port: model params, bank stacks, optimizer state, per-layer splits."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(u[k] for u in trees)) for k in sorted(t)}
    if isinstance(t, list):
        return [tree_map(fn, *u) for u in zip(*trees)]
    return fn(*trees)


def leaves_with_path(tree: Tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(JAX key path, leaf) pairs in JAX's flattening order (sorted keys)."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}['{k}']"
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves_with_path(v, path))
        else:
            out.append((path, v))
    return out


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(JAX key path, leaf)`` over a tree of nested dicts (and lists,
    as ``[i]``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}['{k}']") for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in JAX's flattening order."""
    return [v for _, v in leaves_with_path(tree)]


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def tree_dot(a: Tree, b: Tree, batch_dims: int = 0) -> torch.Tensor:
    """Sum of elementwise products; the first ``batch_dims`` axes are kept
    (per-row dot products of stacked trees)."""
    out = 0
    for x, y in zip(leaves(a), leaves(b)):
        prod = x * y
        out = out + prod.reshape(prod.shape[:batch_dims] + (-1,)).sum(-1)
    return out


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_size(a: Tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(x.numel() for x in leaves(a))


def tree_bytes(a: Tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(a))


def tree_cast(a: Tree, dtype: torch.dtype) -> Tree:
    """Floating leaves cast to ``dtype``; integer and bool leaves kept."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)
