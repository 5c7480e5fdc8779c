"""Gradient sketches: fixed-dimension client-update fingerprints.

Port of ``repro.core.sketch``: seeded Johnson-Lindenstrauss projections
with Rademacher (±1) matrices drawn from the port's threefry
(``repro_torch.random``), bit-equal to the JAX package's matrices. A
matrix depends only on (seed, leaf shape), so it is drawn once per device
and cached. Strategies:

- ``full_proj``       project every leaf
- ``last_block_proj`` project only leaves whose JAX key path (``['w2']``)
                      contains one of ``path_filter`` (the MLP's head)

Leaf order follows JAX's sorted dict flattening (``b0, b1, b2, w0, ...``),
and leaf i of the selection uses seed ``seed * 7919 + i``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import random as rnd


def _block_size(n: int) -> int:
    """Projection block: at most 2**16, halved for small leaves (>= 128)."""
    block = 1 << 16
    while block > 128 and block // 2 >= n:
        block //= 2
    return block


def projection_blocks(n: int, d_sketch: int, seed: int, device) -> List[torch.Tensor]:
    """The (block, d_sketch) Rademacher matrices of a flat leaf of n values."""
    block = _block_size(n)
    key = rnd.key(seed, device=device)
    return [rnd.rademacher(rnd.fold_in(key, i), (block, d_sketch)) for i in range(max(1, -(-n // block)))]


def leaf_projection(flat: torch.Tensor, blocks: List[torch.Tensor]) -> torch.Tensor:
    """Project rows of flat leaves (R, n) to (R, d_sketch): blocked, scaled
    by 1/sqrt(n), summing block products in order like the JAX scan."""
    flat = flat.float()
    R, n = flat.shape
    d_sketch = blocks[0].shape[1]
    block = blocks[0].shape[0]
    pad = len(blocks) * block - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    out = torch.zeros((R, d_sketch), dtype=torch.float32, device=flat.device)
    for i, r in enumerate(blocks):
        out = out + flat[:, i * block:(i + 1) * block] @ r
    return out / math.sqrt(max(n, 1))


@dataclasses.dataclass(frozen=True)
class GradientSketcher:
    d_sketch: int = 256
    strategy: str = "full_proj"  # full_proj | last_block_proj
    path_filter: Sequence[str] = ("final_norm", "head")
    seed: int = 1234
    # projection matrices by (leaf size, leaf index, device): drawn once
    _blocks: Dict[Tuple[int, int, str], List[torch.Tensor]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    def _selected(self, names: Sequence[str]) -> List[str]:
        names = sorted(names)  # JAX's dict flattening order
        if self.strategy == "full_proj":
            return names
        if self.strategy == "last_block_proj":
            # JAX keystr of a dict leaf is "['name']"; the filter matches
            # substrings of it (the MLP head filter is "'w2'", "'b2'")
            return [k for k in names if any(f in f"['{k}']" for f in self.path_filter)]
        raise NotImplementedError(f"sketch strategy {self.strategy!r}: later port slice")

    def batch(self, updates: Dict[str, torch.Tensor]) -> torch.Tensor:
        """updates: parameter dict with a leading row axis (R, ...) ->
        (R, d_sketch) float32 sketches, one per row."""
        picked = self._selected(list(updates))
        R = next(iter(updates.values())).shape[0]
        dev = next(iter(updates.values())).device
        acc = torch.zeros((R, self.d_sketch), dtype=torch.float32, device=dev)
        for i, k in enumerate(picked):
            flat = updates[k].reshape(R, -1)
            ck = (flat.shape[1], i, str(dev))
            if ck not in self._blocks:
                self._blocks[ck] = projection_blocks(
                    flat.shape[1], self.d_sketch, self.seed * 7919 + i, dev
                )
            acc = acc + leaf_projection(flat, self._blocks[ck])
        return acc
