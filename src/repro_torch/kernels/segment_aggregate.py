"""Launch wrapper of the CUDA segment-sum kernel (``csrc/segment_aggregate.cu``).

Port of the Pallas kernel ``repro.kernels.segment_aggregate.segment_aggregate``.
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def segment_aggregate(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """data: (C, P, D) f32/bf16, ids: (C, P) int32, weights: (C, P) f32 or
    None (= 1), all contiguous on one CUDA device -> (C, K, D) float32.
    Ids outside [0, K) are dropped. Launches on the current stream; the
    output is the only allocation."""
    global launches
    dev = data.device
    if dev.type != "cuda" or ids.device != dev or (weights is not None and weights.device != dev):
        raise ValueError("segment kernel needs CUDA tensors on one device")
    if data.dtype not in _DTYPES:
        raise TypeError(f"segment kernel takes f32 or bf16 data, got {data.dtype}")
    if ids.dtype != torch.int32 or (weights is not None and weights.dtype != torch.float32):
        raise TypeError("segment kernel takes int32 ids and float32 weights")
    if data.dim() != 3 or ids.shape != data.shape[:2] or (
        weights is not None and weights.shape != ids.shape
    ):
        raise ValueError(
            f"segment kernel shapes: data (C,P,D), ids/weights (C,P); got "
            f"{tuple(data.shape)}, {tuple(ids.shape)}"
        )
    if not (data.is_contiguous() and ids.is_contiguous() and (weights is None or weights.is_contiguous())):
        raise ValueError("segment kernel inputs must be contiguous")
    C, P, D = data.shape
    K = int(num_segments)
    if max(C, P, K, D) >= 2**31:
        raise ValueError("segment kernel takes 32-bit sizes")
    out = torch.empty((C, K, D), dtype=torch.float32, device=dev)
    if C == 0 or K == 0 or D == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.library().auxo_segment_aggregate(
            data.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(),
            out.data_ptr(), C, P, K, D, _DTYPES[data.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_aggregate kernel launch failed: cudaError {err}")
    launches += 1
    return out
