"""Launch wrapper of the CUDA segment-sum kernel (``csrc/segment_aggregate.cu``).

Port of the Pallas kernel ``repro.kernels.segment_aggregate.segment_aggregate``.
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the plain
version in ``kernels/ref.py``. Every sum is the plain version's, bit for
bit: each segment's rows added in row order from +0 (``index_add_``).
A fake tensor (``FakeTensorMode``: the dry run's memory and FLOP plan,
for the card) gets the kernel's output allocation and no launch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ID_DTYPES = {torch.int32: 0, torch.int64: 1}
CHUNK = 256  # rows a block sorts at once (kChunk in the source)
TILE_BYTES = 128  # bytes of a row a block owns (kRowBytes)
MAX_SPLIT = 8  # segment groups of a column tile, at most (kMaxSplit)


def plan_splits(C: int, P: int, D: int, K: int, element_size: int, sms: int) -> int:
    """Blocks over which each column tile's K segments are split (block y
    of n sums segments ``[y*K//n, (y+1)*K//n)`` over all P rows, so no
    segment's rows are cut): 1 unless the column tiles of all cohorts fill
    less than a wave of ``sms`` SMs and P spans several chunks; then as
    many groups (at most MAX_SPLIT and K) as bring the grid to two blocks
    per SM."""
    nch = math.ceil(P / CHUNK)
    tiles = C * math.ceil(D * element_size / TILE_BYTES)
    if nch <= 1 or K <= 1 or tiles >= sms:
        return 1
    return min(K, MAX_SPLIT, math.ceil(2 * sms / tiles))


def segment_aggregate(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """data: (C, P, D) f32/bf16, ids: (C, P) int32 or int64, weights: (C, P)
    f32 or None (= 1), all contiguous on one CUDA device -> (C, K, D)
    float32. Ids outside [0, K) are dropped. One launch on the current
    stream; the output is the only allocation."""
    global launches
    dev = data.device
    if (dev.type != "cuda" and not is_fake(data)) or ids.device != dev or (
            weights is not None and weights.device != dev):
        raise ValueError("segment kernel needs CUDA tensors on one device")
    if data.dtype not in _DTYPES:
        raise TypeError(f"segment kernel takes f32 or bf16 data, got {data.dtype}")
    if ids.dtype not in _ID_DTYPES or (weights is not None and weights.dtype != torch.float32):
        raise TypeError(f"segment kernel takes int32/int64 ids and float32 weights, got {ids.dtype}")
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
    if max(C, P, D) >= 2**31 or K >= 2**28:
        raise ValueError("segment kernel takes 32-bit sizes and K below 2**28")
    out = torch.empty((C, K, D), dtype=torch.float32, device=dev)
    if C == 0 or K == 0 or D == 0 or is_fake(data):
        return out
    nsplit = plan_splits(C, P, D, K, data.element_size(), build.sm_count(dev.index))
    err = build.launch(
        build.function("auxo_segment_aggregate"), dev,
        data.data_ptr(), ids.data_ptr(), None if weights is None else weights.data_ptr(),
        out.data_ptr(), C, P, K, D, _DTYPES[data.dtype], _ID_DTYPES[ids.dtype], nsplit,
    )
    if err != 0:
        raise RuntimeError(f"segment_aggregate kernel launch failed: cudaError {err}")
    launches += 1
    return out
