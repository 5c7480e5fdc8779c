"""Launch wrapper of the CUDA cosine-similarity kernel (``csrc/cosine_sim.cu``).

Port of the Pallas kernel ``repro.kernels.cosine_sim.cosine_similarity``.
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the plain
version in ``kernels/ref.py``. A fake tensor (``FakeTensorMode``: the dry
run's plan, for the card) gets the kernel's output allocation and no
launch.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cosine_similarity(x: torch.Tensor, c: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x: (C, P, D), c: (C, K, D), same dtype (f32 or bf16), contiguous, on
    one CUDA device -> (C, P, K) float32 sims. One launch on the current
    stream; the output is the only allocation."""
    global launches
    if (x.device.type != "cuda" and not is_fake(x)) or c.device != x.device:
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
    if C == 0 or P == 0 or K == 0 or is_fake(x):
        return out
    el = x.element_size()
    vec = x.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0 and (D * el) % 16 == 0
    err = build.launch(
        build.function("auxo_cosine_similarity"), x.device,
        x.data_ptr(), c.data_ptr(), out.data_ptr(), C, P, K, D, _DTYPES[x.dtype], float(eps),
        int(vec), build.sm_count(x.device.index),
    )
    if err != 0:
        raise RuntimeError(f"cosine_similarity kernel launch failed: cudaError {err}")
    launches += 1
    return out
