"""Launch wrapper of the CUDA cosine-similarity kernel (``csrc/cosine_sim.cu``).

Port of the Pallas kernel ``repro.kernels.cosine_sim.cosine_similarity``.
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cosine_similarity(x: torch.Tensor, c: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x: (C, P, D), c: (C, K, D), same dtype (f32 or bf16), contiguous, on
    one CUDA device -> (C, P, K) float32 sims. Launches on the current
    stream; the output is the only allocation."""
    global launches
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"cosine kernel needs CUDA tensors on one device, got {x.device}, {c.device}")
    if x.dtype not in _DTYPES or c.dtype != x.dtype:
        raise TypeError(f"cosine kernel takes f32 or bf16 inputs of one dtype, got {x.dtype}, {c.dtype}")
    if x.dim() != 3 or c.dim() != 3 or c.shape[0] != x.shape[0] or c.shape[2] != x.shape[2]:
        raise ValueError(f"cosine kernel shapes: x (C,P,D), c (C,K,D); got {tuple(x.shape)}, {tuple(c.shape)}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("cosine kernel inputs must be contiguous")
    C, P, D = x.shape
    K = c.shape[1]
    if max(C, P, K, D) >= 2**31:
        raise ValueError("cosine kernel takes 32-bit sizes")
    out = torch.empty((C, P, K), dtype=torch.float32, device=x.device)
    if C == 0 or P == 0 or K == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = build.library().auxo_cosine_similarity(
            x.data_ptr(), c.data_ptr(), out.data_ptr(), C, P, K, D,
            _DTYPES[x.dtype], float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"cosine_similarity kernel launch failed: cudaError {err}")
    launches += 1
    return out
