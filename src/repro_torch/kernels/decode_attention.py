"""Launch wrapper of the CUDA split-KV decode-attention kernel
(``csrc/decode_attention.cu``).

Port of the Pallas kernel ``repro.kernels.decode_attention.decode_attention``.
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the plain
version in ``kernels/ref.py``. A fake tensor (``FakeTensorMode``: the dry
run's plan, for the card) gets the kernel's output allocation and no
launch (nor the split pass's buffer of partial softmaxes, whose size
depends on the card's SMs).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0); one call
# (the split pass and, with several splits, its merge) counts once
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16  # query heads per KV head (kMaxGroup in the source)
TILE = 64  # tokens of one block step (kTile in the source): chunks are multiples of it
MIN_CHUNK = 512  # fewer tokens than this per block do not pay for a merge


def plan_splits(B: int, Hkv: int, S: int, sms: int, per_sm: int) -> Tuple[int, int]:
    """(n_split, chunk): the KV axis of each (sequence, KV head) cut into
    n_split chunks of ``chunk`` tokens, from the shapes and the card alone
    (no length is read, so nothing syncs). The grid is one wave: B * Hkv *
    n_split blocks, at most the ``sms * per_sm`` that the card holds at
    once (``per_sm`` resident blocks per SM), since a partial second wave
    costs up to 40%. One split, chunk = S, when S is short or the pairs
    fill half the wave or more; else chunks of a multiple of TILE tokens,
    at least MIN_CHUNK. A block whose chunk starts past its sequence's
    length exits at once, so ragged lengths cost what they hold."""
    pairs, slots = B * Hkv, sms * per_sm
    if S <= MIN_CHUNK or 2 * pairs > slots:
        return 1, S
    chunk = max(MIN_CHUNK, math.ceil(S / (slots // pairs) / TILE) * TILE)
    n = math.ceil(S / chunk)
    return (1, S) if n == 1 else (n, chunk)


sm_count = build.sm_count  # the number of SMs of a CUDA device, read once


@functools.lru_cache(maxsize=None)
def blocks_per_sm(index: int, hd: int, g: int, dtype: torch.dtype) -> int:
    """Split-kernel blocks one SM of device ``index`` holds at once (the
    CUDA occupancy calculator on the kernel's registers and shared
    memory), read once per shape class."""
    with torch.cuda.device(index):
        n = build.library().auxo_decode_blocks_per_sm(hd, g, _DTYPES[dtype])
    if n < 1:
        raise RuntimeError(f"decode kernel occupancy query failed: {n}")
    return n


def aligned(t: torch.Tensor, strides) -> bool:
    """16-byte aligned start (a fake tensor has no address) and strides."""
    el = t.element_size()
    return (is_fake(t) or t.data_ptr() % 16 == 0) and all((s * el) % 16 == 0 for s in strides)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: torch.Tensor
) -> torch.Tensor:
    """q: (B, H, hd) contiguous; k, v: (B, S, Hkv, hd) whose (Hkv, hd) axes
    are dense (any batch and sequence strides, 16-byte aligned); length:
    (B,) int32; all f32 or all bf16 on one CUDA device, hd in {16, 32, 64,
    128}, at most 16 query heads per KV head. Returns (B, H, hd) in q's
    dtype. One launch on the current stream (two with several splits: the
    split pass and its merge); the output, and with several splits one
    buffer of partial softmaxes, are the only allocations."""
    global launches
    dev = q.device
    if (dev.type != "cuda" and not is_fake(q)) or any(t.device != dev for t in (k, v, length)):
        raise ValueError(f"decode kernel needs CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}, {length.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode kernel takes f32 or bf16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode kernel shapes: q (B,H,hd), k = v (B,S,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or H % Hkv:
        raise ValueError(f"decode kernel: q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if length.dtype != torch.int32 or tuple(length.shape) != (B,) or not length.is_contiguous():
        raise ValueError(f"decode kernel length must be contiguous int32 ({B},), got "
                         f"{length.dtype} {tuple(length.shape)}")
    if not q.is_contiguous():
        raise ValueError("decode kernel q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"decode kernel {name}: the (Hkv, hd) axes must be dense, "
                             f"strides {t.stride()}")
        if not aligned(t, t.stride()[:2]):
            raise ValueError(f"decode kernel {name}: rows must be 16-byte aligned")
    if B == 0 or S == 0:
        raise ValueError("decode kernel needs B >= 1 and S >= 1")
    if max(B * H, S, B * Hkv) >= 2**31:
        raise ValueError("decode kernel takes 32-bit sizes")
    g = H // Hkv
    if g > MAX_GROUP:
        raise ValueError(f"decode kernel takes at most {MAX_GROUP} query heads per KV head, got {g}")
    if is_fake(q):
        return torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    ns, chunk = plan_splits(B, Hkv, S, sm_count(dev.index),
                            blocks_per_sm(dev.index, hd, g, q.dtype))
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    part = (torch.empty(B * Hkv * ns * g * (hd + 2), dtype=torch.float32, device=dev)
            if ns > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.library().auxo_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            B, H, Hkv, hd, S, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            ns, chunk, _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
