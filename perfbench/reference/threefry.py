"""Threefry-2x32 Rademacher matrices, the draws ``jax.random`` makes with
partitionable threefry: a key is the two uint32 words ``(0, seed)``;
``fold_in(key, i)`` is the block function of the key over the counter
words ``(0, i)``; the bits of element ``j`` of a draw are the two output
words of the block function over ``(0, j)`` xor'ed, and the Rademacher
sign is -1 where the top bit is set.

The block function on tensors runs on int32 bit patterns, whose additions
wrap as uint32 ones do; the right shifts are masked. Plain torch; a copy of
the algorithm, not of the program.
"""
from __future__ import annotations

from typing import Tuple

import torch

M = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _s32(v: int) -> int:
    v &= M
    return v - (1 << 32) if v >= 1 << 31 else v


def block_int(k1: int, k2: int, x1: int, x2: int) -> Tuple[int, int]:
    """The 20-round block function on Python ints (uint32 words)."""
    ks = (k1 & M, k2 & M, (k1 ^ k2 ^ PARITY) & M)
    x, y = (x1 + ks[0]) & M, (x2 + ks[1]) & M
    for i in range(5):
        for r in ROT[i % 2]:
            x = (x + y) & M
            y = ((y << r) | (y >> (32 - r))) & M
            y ^= x
        x = (x + ks[(i + 1) % 3]) & M
        y = (y + ks[(i + 2) % 3] + i + 1) & M
    return x, y


def block_tensor(k1: int, k2: int, x2: torch.Tensor) -> torch.Tensor:
    """Both output words xor'ed, for the counters ``(0, x2)`` (int32 tensor)."""
    ks = (_s32(k1), _s32(k2), _s32(k1 ^ k2 ^ PARITY))
    x = torch.full_like(x2, ks[0])
    y = x2 + ks[1]
    tmp = torch.empty_like(y)
    for i in range(5):
        for r in ROT[i % 2]:
            x.add_(y)
            torch.bitwise_right_shift(y, 32 - r, out=tmp)
            tmp.bitwise_and_((1 << r) - 1)
            y.bitwise_left_shift_(r).bitwise_or_(tmp).bitwise_xor_(x)
        x.add_(ks[(i + 1) % 3])
        y.add_(_s32(ks[(i + 2) % 3] + i + 1))
    return x.bitwise_xor_(y)


def key(seed: int) -> Tuple[int, int]:
    return 0, int(seed) & M


def fold_in(k: Tuple[int, int], data: int) -> Tuple[int, int]:
    return block_int(k[0], k[1], 0, int(data))


def rademacher(k: Tuple[int, int], rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols) float32 matrix of +-1."""
    ctr = torch.arange(rows * cols, dtype=torch.int32, device=device)
    bits = block_tensor(k[0], k[1], ctr)
    return torch.where(bits < 0, -1.0, 1.0).reshape(rows, cols)
