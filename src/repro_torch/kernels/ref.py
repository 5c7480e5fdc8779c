"""Plain PyTorch versions of the CUDA kernels (the correctness contract).

``kernels/ops.py`` sends CPU tensors here; the CUDA kernels are held
against these on the card (``chip_smoke.py``). The cosine and segment
versions accept an optional leading cohort axis. The sketch's projection
is the gradient sketch's own block-by-block path (``core.sketch``).
"""
from __future__ import annotations

import math
from typing import Iterable, Iterator, Optional

import torch

from repro_torch import random as rnd
from repro_torch.utils import trace


def cosine_similarity(x: torch.Tensor, c: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x: (..., P, D), c: (..., K, D) -> (..., P, K) cosine similarities."""
    x = x.float()
    c = c.float()
    dots = x @ c.transpose(-1, -2)
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    cn = torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    return dots / torch.clamp(xn * cn.transpose(-1, -2), min=eps)


def segment_aggregate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """data: (..., P, D); ids: (..., P) -> (..., K, D) weighted segment sums.

    Each segment adds its rows one after another in row order, starting
    from zero (``index_add_``), so a segment's sum does not depend on where
    its rows sit in the call: the same rows at another offset, or in another
    cohort block of a stacked call, give the same bits (the elastic remesh
    relies on it; a one-hot matmul groups rows by the GEMM's blocking).
    Ids outside [0, K) contribute nothing.
    """
    d = data.float()
    if weights is not None:
        d = d * weights.float()[..., None]
    lead, (P, D) = d.shape[:-2], d.shape[-2:]
    C, K = math.prod(lead), int(num_segments)
    ids = segment_ids.long().reshape(C, P)
    # every cohort gets K rows of the output; ids outside [0, K) go to one
    # spare row past them, which is dropped
    rows = torch.where((ids >= 0) & (ids < K),
                       ids + K * torch.arange(C, device=d.device)[:, None], C * K)
    out = torch.zeros((C * K + 1, D), dtype=torch.float32, device=d.device)
    out.index_add_(0, rows.reshape(-1), d.reshape(C * P, D))
    return out[: C * K].reshape(*lead, K, D)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length
) -> torch.Tensor:
    """GQA decode attention (port of ``repro.kernels.ref.decode_attention``).

    q: (B, H, hd); k, v: (B, S, Hkv, hd); length: scalar or (B,) valid KV
    count. Positions >= length score -1e30, so ``length == 0`` gives the
    mean of V over all S. Returns (B, H, hd) in q's dtype.
    """
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    scores = torch.einsum("bngk,bsnk->bngs", qg, k.float()) / math.sqrt(hd)
    t = torch.arange(S, device=q.device)
    n = torch.as_tensor(length, device=q.device).broadcast_to((B,))
    valid = t[None, :] < n[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bsnk->bngk", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def rademacher_blocks(n: int, block: int, d_sketch: int, seed: int, device) -> Iterator[torch.Tensor]:
    """The (block, d_sketch) Rademacher matrices of a flat leaf of n values:
    block i from ``fold_in(key(seed), i)``, drawn one at a time, each draw a
    ``sketch.draw`` span."""
    key = rnd.key(seed, device=device)
    for i in range(max(1, -(-n // block))):
        with trace.span("sketch.draw"):
            r = rnd.rademacher(rnd.fold_in(key, i), (block, d_sketch))
        yield r


def leaf_projection(flat: torch.Tensor, blocks: Iterable[torch.Tensor]) -> torch.Tensor:
    """Project rows of flat leaves (R, n) to (R, d_sketch): blocked, scaled
    by 1/sqrt(n), summing block products in order like the JAX scan. The
    last block is padded with zeros, as the JAX package pads the leaf. Each
    block's product is a ``sketch.project`` span."""
    R, n = flat.shape
    out = None
    lo = 0
    for r in blocks:
        with trace.span("sketch.project"):
            part = flat[:, lo:lo + r.shape[0]].float()
            if part.shape[1] < r.shape[0]:
                part = torch.nn.functional.pad(part, (0, r.shape[0] - part.shape[1]))
            prod = part @ r
            out = prod if out is None else out + prod
        lo += r.shape[0]
    return out / math.sqrt(max(n, 1))


def sketch_project(flat: torch.Tensor, block: int, d_sketch: int, seed: int) -> torch.Tensor:
    """flat: (R, n) rows -> (R, d_sketch) float32: the rows projected by the
    Rademacher blocks of ``block`` rows drawn from ``seed``, one block after
    another, scaled by 1/sqrt(n)."""
    return leaf_projection(flat, rademacher_blocks(flat.shape[1], block, d_sketch, seed, flat.device))
