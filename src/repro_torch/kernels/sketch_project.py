"""Launch wrapper of the CUDA sketch projection (``csrc/sketch_project.cu``).

No TPU kernel behind it: the JAX package draws the sketch's Rademacher
matrices with ``jax.random`` and leaves the draw to XLA. The kernel makes
each threefry sign in registers and multiplies it into the rows at once, so
the (block, d) matrices of ``core.sketch.projection_blocks`` are never
written. CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to the
plain version in ``kernels/ref.py`` (the blocks drawn and multiplied one at
a time). A fake tensor (``FakeTensorMode``: the dry run's plan, for the
card) gets the kernel's output allocation and no launch.

The work split is ``chunk_rows``'s, pure Python: a CTA takes a chunk of rows
of one projection block (a power of two that divides the block), and the
chunks' partial sums, ``(CTAs, R, d)`` floats, are added in a fixed order by
a second launch.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build

# kernel launches since import (or since a caller reset it to 0): a call
# launches one pass per 16 rows and the reduction
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PASS_ROWS = 16  # rows of x a pass takes (kMaxRows in the source)
MAX_CHUNK = 1 << 13  # rows a CTA takes at most
MIN_CHUNK = 1 << 8  # rows a CTA takes at least (unless the block is smaller)
CTAS = 1024  # CTAs a leaf's chunks reach before a chunk grows past MIN_CHUNK


def chunk_rows(n: int, block: int) -> int:
    """Rows a CTA takes of a leaf of n values projected in blocks of
    ``block`` rows: the largest power of two up to ``MAX_CHUNK`` and the
    block whose chunks still number ``CTAS`` or more, and at least
    ``MIN_CHUNK`` (or the block). It divides the block, so a chunk lies in
    one block. It depends on the shape alone, so the sums' order does too."""
    chunk = min(block, MAX_CHUNK)
    while chunk > MIN_CHUNK and -(-n // chunk) < CTAS:
        chunk //= 2
    return chunk


def partials(n: int, block: int) -> int:
    """Partial sums a column and row: the number of chunks."""
    return -(-n // chunk_rows(n, block))


def call_bytes(R: int, n: int, block: int, d: int, itemsize: int) -> int:
    """Bytes a call moves at the least: the rows read once, the partial
    sums written and read back, the output written."""
    return R * n * itemsize + 2 * partials(n, block) * R * d * 4 + R * d * 4


def sketch_project(flat: torch.Tensor, block: int, d: int, seed: int) -> torch.Tensor:
    """flat: (R, n) float32 or bfloat16 rows on one CUDA device, each row
    contiguous (the rows themselves any stride apart: a leaf's last-block
    slice is read in place) -> (R, d) float32, the rows projected by the
    Rademacher blocks of ``block`` rows drawn from ``seed`` and scaled by
    1/sqrt(n). ``ceil(R / 16) + 1`` launches on the current stream; the
    output and the partial sums are the only allocations."""
    global launches
    if flat.device.type != "cuda" and not is_fake(flat):
        raise ValueError(f"sketch kernel needs a CUDA tensor, got {flat.device}")
    if flat.dtype not in _DTYPES:
        raise TypeError(f"sketch kernel takes f32 or bf16 rows, got {flat.dtype}")
    if flat.dim() != 2 or (flat.shape[1] > 1 and flat.stride(1) != 1):
        raise ValueError(f"sketch kernel takes (R, n) rows, each contiguous; got {tuple(flat.shape)} "
                         f"strides {flat.stride()}")
    R, n = flat.shape
    if not (128 <= block <= 1 << 16 and block & (block - 1) == 0) or d < 1:
        raise ValueError(f"sketch kernel takes a power-of-two block in [128, 65536] and d >= 1, "
                         f"got {block}, {d}")
    out = torch.empty((R, d), dtype=torch.float32, device=flat.device)
    if is_fake(flat) or R == 0:
        return out
    if n == 0:
        return out.zero_()
    chunk = chunk_rows(n, block)
    part = torch.empty((-(-n // chunk), R, d), dtype=torch.float32, device=flat.device)
    scale = np.float32(1.0 / math.sqrt(n))  # as torch divides a CUDA tensor by a Python float
    stride = flat.stride(0) if R > 1 else n
    err = build.launch(
        build.function("auxo_sketch_project"), flat.device,
        flat.data_ptr(), _DTYPES[flat.dtype], stride, R, n, block, d, int(seed) & 0xFFFFFFFF, chunk,
        part.data_ptr(), float(scale), out.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"sketch_project kernel launch failed: cudaError {err}")
    launches += -(-R // PASS_ROWS) + 1
    return out
