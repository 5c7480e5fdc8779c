"""Launch wrapper of the CUDA split-KV decode-attention kernel
(``csrc/decode_attention.cu``).

Port of the Pallas kernel ``repro.kernels.decode_attention.decode_attention``.
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0); one call
# (the split pass and its merge) counts once
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
TILE = 32  # tokens per shared-memory tile (kTile in the source)


def n_splits(B: int, Hkv: int, S: int, device) -> int:
    """KV chunks per (sequence, KV head): enough blocks to fill the card's
    SMs about twice over, and no more chunks than tiles of S."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(2 * sms / (B * Hkv)), math.ceil(S / TILE), 65535))


def aligned(t: torch.Tensor, strides) -> bool:
    el = t.element_size()
    return t.data_ptr() % 16 == 0 and all((s * el) % 16 == 0 for s in strides)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: torch.Tensor
) -> torch.Tensor:
    """q: (B, H, hd) contiguous; k, v: (B, S, Hkv, hd) whose (Hkv, hd) axes
    are dense (any batch and sequence strides, 16-byte aligned); length:
    (B,) int32; all f32 or all bf16 on one CUDA device, hd in {16, 32, 64,
    128}. Returns (B, H, hd) in q's dtype. Launches on the current stream;
    the output and the split partials are the only allocations."""
    global launches
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, length)):
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
    ns = n_splits(B, Hkv, S, dev)
    g = H // Hkv
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    part_m = torch.empty((B * Hkv, ns, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * Hkv, ns, g, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.library().auxo_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            B, H, Hkv, hd, S, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            ns, _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
