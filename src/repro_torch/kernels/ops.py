"""Public wrappers of the kernels: dtype policy, layout, device dispatch.

Same contract as ``repro.kernels.ops``:
  - any P, D and K; zero rows give similarity 0 (the CUDA kernels mask
    their ragged tile edges themselves, so nothing is padded or copied);
  - decode attention takes any S and a scalar or (B,) length; the kernel
    reads only each sequence's valid prefix, in place;
  - ids outside [0, K) (the JAX package's padding id is -1) carry weight 0
    and are dropped; ``weights=None`` means 1;
  - a leading cohort axis ``(C, P, D)`` is ONE launch;
  - the output is float32.
A CPU tensor goes to the plain version (``kernels/ref.py``), a CUDA tensor
to the CUDA kernel; there is no fallback between the two, and any other
device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cosine_sim as _cs
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref
from repro_torch.kernels import segment_aggregate as _sa

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def cosine_similarity(x: torch.Tensor, c: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x: (P, D), c: (K, D) -> (P, K) cosine sims; or x (C, P, D) with
    c (C, K, D) -> (C, P, K) in one launch."""
    if _route(x) == "cpu":
        return ref.cosine_similarity(x, c, eps)
    lead = x.dim() == 2
    if lead:
        x, c = x[None], c[None]
    if x.dtype != c.dtype or x.dtype not in _KERNEL_DTYPES:
        x, c = x.float(), c.float()
    out = _cs.cosine_similarity(x.contiguous(), c.contiguous(), eps)
    return out[0] if lead else out


def segment_aggregate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """data: (P, D), ids: (P,) -> (K, D) weighted segment sums; or data
    (C, P, D) with ids (and weights) (C, P) -> (C, K, D) in one launch."""
    if _route(data) == "cpu":
        return ref.segment_aggregate(data, segment_ids, num_segments, weights)
    lead = data.dim() == 2
    if lead:
        data = data[None]
        segment_ids = segment_ids[None]
        weights = None if weights is None else weights[None]
    if data.dtype not in _KERNEL_DTYPES:
        data = data.float()
    ids = segment_ids.to(torch.int32).contiguous()
    w = None if weights is None else weights.to(torch.float32).contiguous()
    out = _sa.segment_aggregate(data.contiguous(), ids, num_segments, w)
    return out[0] if lead else out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length) -> torch.Tensor:
    """GQA decode attention over a KV cache (flash-decode).

    q: (B, H, hd); k, v: (B, S, Hkv, hd); length: scalar or (B,) valid KV
    count. Returns (B, H, hd) in q's dtype. K and V are read in place when
    their (Hkv, hd) axes are dense and their rows 16-byte aligned (a layer
    slice of the paged cache is); otherwise they are copied dense first.
    """
    if _route(q) == "cpu":
        return ref.decode_attention(q, k, v, length)
    B, hd = q.shape[0], q.shape[-1]
    dt = q.dtype if q.dtype in _KERNEL_DTYPES and k.dtype == v.dtype == q.dtype else torch.float32

    def rows(t):
        t = t.to(dt)
        if t.stride(3) == 1 and t.stride(2) == hd and _da.aligned(t, t.stride()[:2]):
            return t
        return t.clone(memory_format=torch.contiguous_format)

    qk, kk, vk = q.to(dt).contiguous(), rows(k), rows(v)
    n = torch.as_tensor(length, device=q.device).to(torch.int32).broadcast_to((B,)).contiguous()
    return _da.decode_attention(qk, kk, vk, n).to(q.dtype)
