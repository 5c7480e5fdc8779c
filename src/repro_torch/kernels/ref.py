"""Plain PyTorch versions of the CUDA kernels (the correctness contract).

``kernels/ops.py`` sends CPU tensors here; the CUDA kernels are held
against these on the card (``chip_smoke.py``). The cosine and segment
versions accept an optional leading cohort axis.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


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

    Ids outside [0, K) match no one-hot column and contribute nothing.
    """
    d = data.float()
    if weights is not None:
        d = d * weights.float()[..., None]
    kk = torch.arange(num_segments, device=d.device)
    onehot = (segment_ids.long()[..., None] == kk).to(d.dtype)  # (..., P, K)
    return onehot.transpose(-1, -2) @ d


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
