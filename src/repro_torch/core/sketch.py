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
- ``tensor_norms``    the float32 L2 norm of every leaf, in leaf order, in
                      the first slots of the sketch (no projection)

Leaves follow JAX's flattening order (sorted keys at every level), and
leaf i of the selection uses seed ``seed * 7919 + i``. Each matrix is drawn
once per call and applied to all rows together; the matrices of a leaf are
kept across calls only while they are small (``CACHE_FLOATS``): the MLP's
head is, a transformer block's 60.8M values at d_sketch 128 (31 GB of
matrices) are not. A leaf too large to keep that lies on the card (or is a
fake tensor) is projected in one kernel call (``kernels.ops.sketch_project``)
that makes each sign in registers from its threefry counter, the same signs
the blocks hold; on the CPU it is drawn block by block (``kernels.ref``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
from repro_torch import random as rnd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import leaf_projection
from repro_torch.utils import spmd, trace
from repro_torch.utils.tree import leaves_with_path, tree_map

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
    drawn one at a time, each draw a ``sketch.draw`` span."""
    return kref.rademacher_blocks(n, _block_size(n), d_sketch, seed, device)


ROW_CHUNK = 1 << 16  # rows of a split leaf's projection drawn at a time


def row_blocks(index: torch.Tensor, n: int, d_sketch: int, seed: int) -> Iterable[Tuple[int, torch.Tensor]]:
    """(start, (len, d_sketch) matrix) pieces of the projection rows at the
    global flat indices ``index`` (a card's shard of a leaf of n values),
    drawn ``ROW_CHUNK`` rows at a time (``random.rademacher_rows``), each
    draw a ``sketch.draw`` span."""
    block = _block_size(n)
    key = rnd.key(seed, device=index.device)
    for lo in range(0, index.shape[0], ROW_CHUNK):
        with trace.span("sketch.draw"):
            r = rnd.rademacher_rows(key, block, index[lo:lo + ROW_CHUNK], d_sketch)
        yield lo, r


def shard_projection(flat: torch.Tensor, index: torch.Tensor, n: int, d_sketch: int, seed: int) -> torch.Tensor:
    """One card's part of ``leaf_projection``: rows (R, n_local) of a leaf
    shard whose elements sit at global flat ``index`` -> (R, d_sketch), its
    sum over the shards being the whole leaf's projection."""
    out = None
    for lo, r in row_blocks(index, n, d_sketch, seed):
        with trace.span("sketch.project"):
            prod = flat[:, lo:lo + r.shape[0]].float() @ r
            out = prod if out is None else out + prod
    return out / math.sqrt(max(n, 1))


@dataclasses.dataclass(frozen=True)
class GradientSketcher:
    d_sketch: int = 256
    strategy: str = "full_proj"  # full_proj | last_block_proj | tensor_norms
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
        if self.strategy in ("full_proj", "tensor_norms"):
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
        raise ValueError(self.strategy)

    def _project(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """(R, d_sketch) projection of leaf i's rows (R, n): by its kept
        matrices where they are small, else in one ``kops.sketch_project``
        call (the kernel on the card, the blocks drawn one by one on the
        CPU)."""
        n = flat.shape[1]
        seed = self.seed * 7919 + i
        if n_blocks(n) * _block_size(n) * self.d_sketch > CACHE_FLOATS:
            return kops.sketch_project(flat, _block_size(n), self.d_sketch, seed)
        ck = (n, i, str(flat.device))
        if ck not in self._blocks:
            self._blocks[ck] = list(projection_blocks(n, self.d_sketch, seed, flat.device))
        return leaf_projection(flat, self._blocks[ck])

    def _tensor_norms(self, picked) -> torch.Tensor:
        """(R, d_sketch): each row's per-leaf norms written as the JAX
        package writes them, ``out[: n % d or d] = norms[:d]`` for n leaves.
        The slice is n wide for n <= d and d wide when d divides n; for any
        other n > d its width differs from the d norms and the JAX package
        raises, so this does too."""
        norms = torch.stack(
            [torch.linalg.vector_norm(l.reshape(l.shape[0], -1).float(), dim=1) for _, l in picked],
            dim=1,
        )  # (R, n)
        R, n = norms.shape
        d = self.d_sketch
        width = n % d or d
        vals = norms[:, :d]
        if vals.shape[1] != width:
            raise ValueError(
                f"Incompatible shapes for broadcasting: {n} leaf norms into a slice of "
                f"{width} of a {d}-dim sketch ({(vals.shape[1],)} vs {(width,)})"
            )
        out = torch.zeros((R, d), dtype=torch.float32, device=norms.device)
        out[:, :width] = vals
        return out

    def __call__(self, update) -> torch.Tensor:
        """update: one client's (unstacked) delta -> (d_sketch,) float32:
        ``batch`` of a one-row stack."""
        return self.batch(tree_map(lambda a: a[None], update))[0]

    def batch(self, updates) -> torch.Tensor:
        """updates: a (flat or nested) parameter dict whose leaves lead with
        a row axis (R, ...) -> (R, d_sketch) float32 sketches, one per row.
        The call is a ``sketch`` span."""
        with trace.span("sketch"):
            return self._batch(updates)

    def _batch(self, updates) -> torch.Tensor:
        if self.strategy == "tensor_norms":
            return self._tensor_norms(self._selected(updates))
        acc = part = None
        for i, (_, leaf) in enumerate(self._selected(updates)):
            if spmd.is_dtensor(leaf):
                proj, split = self._project_shards(leaf, i)
                if split:  # a sum of the cards' parts, reduced once below
                    part = proj if part is None else part + proj
                    continue
            else:
                proj = self._project(leaf.reshape(leaf.shape[0], -1), i)
            acc = proj if acc is None else acc + proj
        if part is not None:
            part = spmd.replicate_partial(part)
            acc = part if acc is None else acc + part
        if acc is None:
            leaf = leaves_with_path(updates)[0][1]
            return torch.zeros((leaf.shape[0], self.d_sketch), dtype=torch.float32, device=leaf.device)
        return acc

    def _project_shards(self, leaf, i: int):
        """(projection, split) of a DTensor leaf (R, ...): each card projects
        its own shard. A leaf that no mesh dim splits beyond its rows takes
        the one-device path on the card's rows (its bits on a (1, 1) mesh);
        a split leaf projects its shard's rows of the matrices (drawn at the
        shard's global row offsets), a ``Partial`` sum over the cards."""
        mesh = leaf.device_mesh
        leaf = spmd.replicate_partial(leaf)
        split = [m for m, p in enumerate(leaf.placements) if p.is_shard() and p.dim > 0 and mesh.size(m) > 1]
        rows = [spmd.shard_dim(p) == 0 for p in leaf.placements]
        out_pl = [spmd._shard(0) if r else (spmd._partial() if m in split else spmd._replicate())
                  for m, r in enumerate(rows)]
        shape = tuple(leaf.shape[1:])
        n = math.prod(shape)
        seed = self.seed * 7919 + i
        if not split:
            def fn(x):
                return self._project(x.reshape(x.shape[0], -1), i)
        else:
            blk = spmd.local_block(leaf)
            mine = rnd.Shard(blk.local_shape[1:], blk.offsets[1:])

            def fn(x):
                index = rnd.block_index(shape, mine, x.device)
                return shard_projection(x.reshape(x.shape[0], -1), index, n, self.d_sketch, seed)
        return spmd.local(fn, (leaf,), out_pl, mesh), bool(split)
