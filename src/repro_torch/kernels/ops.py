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
device raises. A fake tensor (``FakeTensorMode``, the dry run's plan)
stands for the card's on any device: it takes the kernel wrapper's shape
rule (the kernel's output allocation, no launch), never the plain version.

A DTensor (the SPMD step's clustering and aggregation) runs the segment
sum on each card's local shards (``utils.spmd.local``): a split of the
rows it sums over leaves a ``Partial`` result, a split of a column or of
the leading cohort axis a split result, and ids or weights are gathered
where the data is whole. The cosine, decode attention and sketch
projection take no DTensor: the SPMD paths call them on local tensors or
not at all.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import cosine_sim as _cs
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref
from repro_torch.kernels import segment_aggregate as _sa
from repro_torch.kernels import sketch_project as _sp
from repro_torch.utils import spmd, trace

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _route(t: torch.Tensor) -> str:
    if is_fake(t) or t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no kernel route for device {t.device}")


def cosine_similarity(x: torch.Tensor, c: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x: (P, D), c: (K, D) -> (P, K) cosine sims; or x (C, P, D) with
    c (C, K, D) -> (C, P, K) in one launch."""
    if _route(x) == "cpu":
        return ref.cosine_similarity(x, c, eps)
    lead = x.dim() == 2
    if lead:
        x, c = x.unsqueeze(0), c.unsqueeze(0)
    if x.dtype != c.dtype or x.dtype not in _KERNEL_DTYPES:
        x, c = x.float(), c.float()
    out = _cs.cosine_similarity(x.contiguous(), c.contiguous(), eps)
    return out.squeeze(0) if lead else out


def segment_aggregate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """data: (P, D), ids: (P,) -> (K, D) weighted segment sums; or data
    (C, P, D) with ids (and weights) (C, P) -> (C, K, D) in one launch.
    The call is a ``kernels.segment_aggregate`` span whose meta holds the
    call's (C, P, D) ``shape``, the data's and the ids' itemsizes, whether
    it is ``weighted`` and ``k``."""
    if not trace.on():
        return _segment_aggregate(data, segment_ids, num_segments, weights)
    shape = tuple(data.shape) if data.dim() == 3 else (1,) + tuple(data.shape)
    with trace.span("kernels.segment_aggregate", shape=shape, data_itemsize=data.element_size(),
                    ids_itemsize=segment_ids.element_size(), weighted=weights is not None, k=num_segments):
        return _segment_aggregate(data, segment_ids, num_segments, weights)


def _segment_aggregate(data, segment_ids, num_segments, weights):
    if spmd.any_dtensor(data, segment_ids, weights):
        return _segment_aggregate_spmd(data, segment_ids, num_segments, weights)
    if _route(data) == "cpu":
        return ref.segment_aggregate(data, segment_ids, num_segments, weights)
    lead = data.dim() == 2
    if lead:
        data = data.unsqueeze(0)
        segment_ids = segment_ids.unsqueeze(0)
        weights = None if weights is None else weights.unsqueeze(0)
    if data.dtype not in _KERNEL_DTYPES:
        data = data.float()
    # the kernel reads int32 and int64 ids as they come: no cast launch
    ids = segment_ids if segment_ids.dtype in (torch.int32, torch.int64) else segment_ids.long()
    w = None if weights is None else weights.to(torch.float32).contiguous()
    out = _sa.segment_aggregate(data.contiguous(), ids.contiguous(), num_segments, w)
    return out.squeeze(0) if lead else out


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


def sketch_project(flat: torch.Tensor, block: int, d_sketch: int, seed: int) -> torch.Tensor:
    """flat: (R, n) rows of a leaf of n values -> (R, d_sketch) float32: the
    gradient sketch's projection of the rows by the threefry Rademacher
    blocks of ``block`` rows drawn from ``seed`` (``core.sketch``), scaled
    by 1/sqrt(n). On the card the rows are read in place where each is
    contiguous, and the call is a ``kernels.sketch_project`` span whose meta
    holds the ``rows``, ``n``, ``d`` and the projection ``blocks``."""
    if _route(flat) == "cpu":
        return ref.sketch_project(flat, block, d_sketch, seed)
    if flat.dtype not in _KERNEL_DTYPES:
        flat = flat.float()
    if flat.shape[1] > 1 and flat.stride(1) != 1:
        flat = flat.contiguous()
    if not trace.on():
        return _sp.sketch_project(flat, block, d_sketch, seed)
    R, n = flat.shape
    with trace.span("kernels.sketch_project", rows=R, n=n, d=d_sketch, blocks=max(1, -(-n // block))):
        return _sp.sketch_project(flat, block, d_sketch, seed)


# ---------------------------------------------------------------------------
# The segment sum of DTensors: each card sums its shards
# ---------------------------------------------------------------------------


def _segment_aggregate_spmd(data, segment_ids, num_segments, weights):
    """Per mesh dim: data split on its rows (P) sums each card's rows, a
    ``Partial`` result (ids and weights split alike); split on D or the
    cohort axis, a result split alike; replicated, ids and weights
    replicated too."""
    mesh = next(t.device_mesh for t in (data, segment_ids, weights) if spmd.is_dtensor(t))
    data, ids, w = (spmd.as_dtensor(t, mesh) for t in (data, segment_ids, weights))
    data = spmd.replicate_partial(data)
    pdim = data.dim() - 2
    dpl, ipl, opl = [], [], []
    for m, p in enumerate(data.placements):
        d = spmd.shard_dim(p) if mesh.size(m) > 1 else None
        if d == pdim:
            dpl.append(p), ipl.append(spmd._shard(ids.dim() - 1)), opl.append(spmd._partial())
        elif d is not None and (d == data.dim() - 1 or (d == 0 and data.dim() == 3)):
            dpl.append(p), ipl.append(spmd._shard(0) if d == 0 else spmd._replicate()), opl.append(p)
        else:
            dpl.append(spmd._replicate()), ipl.append(spmd._replicate()), opl.append(spmd._replicate())
    data = spmd.redistribute(data, dpl)
    ids = spmd.redistribute(spmd.replicate_partial(ids), ipl)
    w = None if w is None else spmd.redistribute(spmd.replicate_partial(w), ipl)
    return spmd.local(lambda d, i, ww: segment_aggregate(d, i, num_segments, ww), (data, ids, w), opl, mesh)
