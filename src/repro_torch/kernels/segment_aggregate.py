"""Launch wrapper of the CUDA segment-sum kernel (``csrc/segment_aggregate.cu``).

Port of the Pallas kernel ``repro.kernels.segment_aggregate.segment_aggregate``.
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the plain
version in ``kernels/ref.py``. Every sum is the plain version's, bit for
bit: each segment's rows added in row order from +0 (``index_add_``).
A fake tensor (``FakeTensorMode``: the dry run's memory and FLOP plan,
for the card) gets the kernel's output allocation and no launch.

The work split is ``plan``'s, pure Python: a block owns one segment of
one cohort and a span of each row's column vectors, lists the segment's
rows once (``CHUNK`` rows at a time) and sweeps the span with them; each
(segment, vector) pair is one thread's chain of adds in row order, so no
segment's rows are ever split between owners.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ID_DTYPES = {torch.int32: 0, torch.int64: 1}
CHUNK = 4096  # rows whose list a block holds at once (kChunk in the source)
WAVES = 8  # blocks per SM the grid grows to before a block's pairs grow
MIN_PAIRS = 32  # pairs a block takes at least (one warp's)
ROWS_A_THREAD = 8  # rows a thread sums, at least, where segments are short (up to 4 pairs)


@dataclass(frozen=True)
class Plan:
    """A call's work split: ``vec_bytes`` bytes of a row a column vector,
    ``rows`` of a pair a thread keeps in flight (2, of 4 pairs at once; 8;
    32; 16-byte vectors always take 4 rows of 2 pairs), ``threads`` a
    block, ``span`` vectors of one segment a block (``nspan`` blocks a
    segment of a cohort), ``chunk`` rows listed at once."""

    vec_bytes: int
    rows: int
    threads: int
    span: int
    chunk: int
    nspan: int


def vector_bytes(D: int, element_size: int, address: int = 0) -> int:
    """The widest vector (16, 8, 4 or 2 bytes, at least one element) that
    divides a row's bytes and the data's address: every row of every
    cohort then starts on a whole vector."""
    vb = 16
    while vb > element_size and ((D * element_size) % vb or address % vb):
        vb //= 2
    return vb


def plan(C: int, P: int, D: int, K: int, element_size: int, sms: int, address: int = 0) -> Plan:
    """The work split of a (C, P, D) -> (C, K, D) call on ``sms`` SMs.

    Each block owns one segment of one cohort and a span of its vectors.
    The vector is the widest the rows allow, narrowed (down to 4 bytes)
    while the (segment, vector) pairs of all cohorts would not give two
    waves of 128-thread blocks: a thread keeps the same rows in flight
    whatever the vector, so narrower vectors keep more bytes in flight.
    A block takes ``ppb`` pairs: as many as bring the grid to two waves
    (at least a warp's, at most ``ppt`` a thread: up to 4 where segments
    are short, so that a thread sums ROWS_A_THREAD rows) or, past 8
    blocks an SM, an 8th of an SM's share, so that a large call streams
    megabytes a block for the one list it builds; with more segments than
    that, a block takes a whole row. Every lane runs a batch's adds, so
    the rows a pair keeps in flight follow the segments' mean length P /
    K: 2 rows of 4 pairs under 4 rows; 32 rows from 32, or from 8 where
    the grid is less than a wave (more rows a thread cost registers, so
    blocks an SM); else 8. Blocks take 256 threads where the pairs fill
    two waves of them (short segments, which take 4 pairs a thread, only
    past 8 blocks an SM of 4 pairs a thread), or where the grid is less
    than one wave (its lists are built by twice the warps)."""
    vb = vector_bytes(D, element_size, address)
    narrowest = max(element_size, min(4, vb))
    while vb > narrowest and C * K * (D * element_size // vb) < 2 * sms * 128:
        vb //= 2
    nv = D * element_size // vb
    pairs = C * K * nv
    short = P < 4 * K
    threads = 256 if pairs >= 2 * sms * 256 and (not short or pairs >= WAVES * sms * 4 * 256) else 128
    ppt = max(1, min(4, ROWS_A_THREAD * K // max(P, 1)))
    ppb = max(min(threads * ppt, max(MIN_PAIRS, pairs // (2 * sms))), math.ceil(pairs / (WAVES * sms)))
    nspan = max(1, min(math.ceil(nv / ppb), WAVES * sms // (C * K)))
    span = math.ceil(nv / nspan)
    nspan = math.ceil(nv / span)
    sub_wave = C * K * nspan <= sms
    if sub_wave:
        threads = 256
    rows = 2 if short else (32 if P >= 32 * K or (P >= 8 * K and sub_wave) else 8)
    return Plan(vb, rows, threads, span, max(1, min(P, CHUNK)), nspan)


def segment_aggregate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """data: (C, P, D) f32/bf16, segment_ids: (C, P) int32 or int64,
    weights: (C, P) f32 or None (= 1), all contiguous on one CUDA device
    -> (C, K, D) float32. Ids outside [0, K) are dropped. One launch on the current
    stream; the output is the only allocation."""
    global launches
    dev = data.device
    if (dev.type != "cuda" and not is_fake(data)) or segment_ids.device != dev or (
            weights is not None and weights.device != dev):
        raise ValueError("segment kernel needs CUDA tensors on one device")
    if data.dtype not in _DTYPES:
        raise TypeError(f"segment kernel takes f32 or bf16 data, got {data.dtype}")
    if segment_ids.dtype not in _ID_DTYPES or (weights is not None and weights.dtype != torch.float32):
        raise TypeError(f"segment kernel takes int32/int64 ids and float32 weights, got {segment_ids.dtype}")
    if data.dim() != 3 or segment_ids.shape != data.shape[:2] or (
        weights is not None and weights.shape != segment_ids.shape
    ):
        raise ValueError(
            f"segment kernel shapes: data (C,P,D), ids/weights (C,P); got "
            f"{tuple(data.shape)}, {tuple(segment_ids.shape)}"
        )
    if not (data.is_contiguous() and segment_ids.is_contiguous()
            and (weights is None or weights.is_contiguous())):
        raise ValueError("segment kernel inputs must be contiguous")
    C, P, D = data.shape
    K = int(num_segments)
    if max(C, P, D) >= 2**31 or K >= 2**28:
        raise ValueError("segment kernel takes 32-bit sizes and K below 2**28")
    out = torch.empty((C, K, D), dtype=torch.float32, device=dev)
    if C == 0 or K == 0 or D == 0 or is_fake(data):
        return out
    pl = plan(C, P, D, K, data.element_size(), build.sm_count(dev.index), data.data_ptr())
    err = build.launch(
        build.function("auxo_segment_aggregate"), dev,
        data.data_ptr(), segment_ids.data_ptr(), None if weights is None else weights.data_ptr(),
        out.data_ptr(), C, P, K, D, _DTYPES[data.dtype], _ID_DTYPES[segment_ids.dtype],
        pl.vec_bytes, pl.rows, pl.threads, pl.span, pl.chunk,
    )
    if err != 0:
        raise RuntimeError(f"segment_aggregate kernel launch failed: cudaError {err}")
    launches += 1
    return out
