"""Gradient sketches: fixed-dimension client-update fingerprints.

Port of ``repro.core.sketch``: seeded Johnson-Lindenstrauss projections
with Rademacher (±1) matrices drawn from the port's threefry
(``repro_torch.random``), bit-equal to the JAX package's matrices. A
leaf of n values is projected in blocks of at most 2**16 rows; block i's
(block, d_sketch) matrix is ``rademacher(fold_in(key(seed), i))``.
Strategies:

- ``full_proj``       project every leaf
- ``last_block_proj`` project the leaves whose JAX key path
                      (``"['w2']"``, ``"['final_norm']['scale']"``) contains
                      one of ``path_filter``, and the ``[last_block_index]``
                      slice of every stacked ``backbone`` leaf (the last
                      transformer block, its norm scales included)

Leaves follow JAX's flattening order (sorted keys at every level), and
leaf i of the selection uses seed ``seed * 7919 + i``. Each matrix is drawn
once per call and applied to all rows together; the matrices of a leaf are
kept across calls only while they are small (``CACHE_FLOATS``): the MLP's
head is, a transformer block's 60.8M values at d_sketch 128 (31 GB of
matrices) are not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.utils.tree import leaves_with_path

CACHE_FLOATS = 1 << 24  # a leaf's matrices are cached up to this many floats (64 MB)


def _block_size(n: int) -> int:
    """Projection block: at most 2**16, halved for small leaves (>= 128)."""
    block = 1 << 16
    while block > 128 and block // 2 >= n:
        block //= 2
    return block


def n_blocks(n: int) -> int:
    return max(1, -(-n // _block_size(n)))


def projection_blocks(n: int, d_sketch: int, seed: int, device) -> Iterable[torch.Tensor]:
    """The (block, d_sketch) Rademacher matrices of a flat leaf of n values,
    drawn one at a time."""
    block = _block_size(n)
    key = rnd.key(seed, device=device)
    return (rnd.rademacher(rnd.fold_in(key, i), (block, d_sketch)) for i in range(n_blocks(n)))


def leaf_projection(flat: torch.Tensor, blocks: Iterable[torch.Tensor]) -> torch.Tensor:
    """Project rows of flat leaves (R, n) to (R, d_sketch): blocked, scaled
    by 1/sqrt(n), summing block products in order like the JAX scan. The
    last block is padded with zeros, as the JAX package pads the leaf."""
    R, n = flat.shape
    out = None
    lo = 0
    for r in blocks:
        part = flat[:, lo:lo + r.shape[0]].float()
        if part.shape[1] < r.shape[0]:
            part = torch.nn.functional.pad(part, (0, r.shape[0] - part.shape[1]))
        prod = part @ r
        out = prod if out is None else out + prod
        lo += r.shape[0]
    return out / math.sqrt(max(n, 1))


@dataclasses.dataclass(frozen=True)
class GradientSketcher:
    d_sketch: int = 256
    strategy: str = "full_proj"  # full_proj | last_block_proj
    path_filter: Sequence[str] = ("final_norm", "head")
    last_block_index: int = -1
    seed: int = 1234
    # small leaves' projection matrices by (leaf size, leaf index, device)
    _blocks: Dict[Tuple[int, int, str], List[torch.Tensor]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    def _selected(self, updates) -> List[Tuple[str, torch.Tensor]]:
        """(key path, (R, ...) rows) of the projected leaves, in order."""
        flat = leaves_with_path(updates)
        if self.strategy == "full_proj":
            return flat
        if self.strategy == "last_block_proj":
            picked = []
            for ks, leaf in flat:
                if any(f in ks for f in self.path_filter):
                    picked.append((ks, leaf))
                elif "backbone" in ks and leaf.dim() - 1 >= 2:
                    # stacked layers (after the row axis): the last block's slice
                    picked.append((ks, leaf[:, self.last_block_index]))
            return picked
        raise NotImplementedError(f"sketch strategy {self.strategy!r}: later port slice")

    def _matrices(self, n: int, i: int, dev) -> Iterable[torch.Tensor]:
        seed = self.seed * 7919 + i
        if n_blocks(n) * _block_size(n) * self.d_sketch > CACHE_FLOATS:
            return projection_blocks(n, self.d_sketch, seed, dev)
        ck = (n, i, str(dev))
        if ck not in self._blocks:
            self._blocks[ck] = list(projection_blocks(n, self.d_sketch, seed, dev))
        return self._blocks[ck]

    def batch(self, updates) -> torch.Tensor:
        """updates: a (flat or nested) parameter dict whose leaves lead with
        a row axis (R, ...) -> (R, d_sketch) float32 sketches, one per row."""
        acc = None
        for i, (_, leaf) in enumerate(self._selected(updates)):
            flat = leaf.reshape(leaf.shape[0], -1)
            proj = leaf_projection(flat, self._matrices(flat.shape[1], i, flat.device))
            acc = proj if acc is None else acc + proj
        if acc is None:
            leaf = leaves_with_path(updates)[0][1]
            return torch.zeros((leaf.shape[0], self.d_sketch), dtype=torch.float32, device=leaf.device)
        return acc
