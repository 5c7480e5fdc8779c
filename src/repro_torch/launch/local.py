"""One card's share of a step's state under a mesh, made on that card alone.

A card of the production mesh holds a block of every parameter (its
placements from ``sharding.param_shardings``); a model too large for one
card (llama4-maverick-400b-a17b: 1.59 TB of float32 params) exists only
as such blocks. This module makes one card's blocks and nothing more:

- ``param_shards``: each leaf's block at given mesh coordinates, as an
  ``rnd.Shard`` (``spmd.block``: local shape and offsets);
- ``init_params``: the card's params, each leaf drawn on its block alone
  (``Model.init_local``) and wrapped as a DTensor: bit-equal to slicing
  ``Model.init``. It is the port's ``jax.jit(init, out_shardings=...)``
  under partitionable threefry, where each device draws its own elements;
- ``train_state``: Yogi's m and v under ``fsdp`` and the replicated
  clustering state, at local shape, filled as ``steps.yogi_init`` and
  ``steps.clustering_init`` fill them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.steps import clustering_init
from repro_torch.utils import spmd
from repro_torch.utils.tree import tree_map


def param_shards(shapes: Any, mesh, policy: str, coords: Sequence[int]) -> Any:
    """Each leaf's block under ``policy`` at ``coords`` (a tree of
    ``rnd.Shard`` shaped like ``shapes``)."""
    sizes = tuple(axis_sizes(mesh).values())
    return tree_map(lambda a, pl: spmd.block(tuple(a.shape), pl, sizes, coords), shapes,
                    shd.param_shardings(shapes, mesh, policy))


def init_params(model, key, mesh, policy: str, coords: Optional[Sequence[int]] = None, device=None) -> Any:
    """The params of the card at ``coords`` (this process's coordinates on
    ``mesh`` when not given) as DTensors on ``mesh``, each local block drawn
    alone on ``device``."""
    coords = tuple(mesh.get_coordinate()) if coords is None else tuple(coords)
    shapes = model.init_shapes()
    local = model.init_local(key, param_shards(shapes, mesh, policy, coords), device)
    return tree_map(lambda a, pl: spmd.from_local(a, mesh, pl), local, shd.param_shardings(shapes, mesh, policy))


def train_state(params: Any, mesh, cluster_k: int, d_sketch: int, device=None) -> Tuple[Dict, Dict]:
    """(Yogi's state, the clustering state) for DTensor ``params``: m (the
    params' dtype, zeros) and v (float32, 1e-6) at their local shape under
    ``fsdp``, the clustering state replicated; nothing whole is made."""
    dev = resolve_device(device)
    sizes = tuple(axis_sizes(mesh).values())
    opl = shd.param_shardings(params, mesh, "fsdp")
    zero = (0,) * len(sizes)

    def filled(a, pl, fill, dtype):
        shape = spmd.block(tuple(a.shape), pl, sizes, zero).local_shape
        return spmd.from_local(torch.full(shape, fill, dtype=dtype, device=dev), mesh, pl)

    opt = {"m": tree_map(lambda a, pl: filled(a, pl, 0.0, a.dtype), params, opl),
           "v": tree_map(lambda a, pl: filled(a, pl, 1e-6, torch.float32), params, opl)}
    repl = shd.replicated(mesh)
    clust = tree_map(lambda a: spmd.from_local(a, mesh, repl), clustering_init(cluster_k, d_sketch, device=dev))
    return opt, clust


__all__ = ["init_params", "param_shards", "train_state"]
