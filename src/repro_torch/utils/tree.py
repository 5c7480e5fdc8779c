"""Arithmetic over parameter dicts ``{name: tensor}`` (the port's pytrees).

Code that walks leaves in order (sketches, DP noise keys, the stage-②
flattening) sorts the names: that is JAX's flattening order for dicts, so
both packages agree.
"""
from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def tree_map(fn, *trees: Tree) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def map_nested(fn, tree):
    """``fn`` on every leaf of a nested dict (bank stacks, model params)."""
    if isinstance(tree, dict):
        return {k: map_nested(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    for k in sorted(a):
        prod = a[k] * b[k]
        out = out + prod.reshape(prod.shape[:batch_dims] + (-1,)).sum(-1)
    return out


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)
