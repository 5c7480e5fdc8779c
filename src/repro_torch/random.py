"""Threefry-2x32 counter-based random numbers, draw-for-draw equal to
``jax.random`` with ``jax_threefry_partitionable=True``.

The JAX package draws model inits, sketch projections, k-means seedings and
per-row training keys from threefry; the port reproduces those streams bit
for bit so that the two packages can be held against each other on the same
seed. Keys are explicit values passed around (no global state): an int64
tensor of shape ``(..., 2)`` whose entries are uint32 words. Every function
accepts a batch of keys (leading dims) and then draws one sample block per
key. The uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks because
torch's uint32 support is partial.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _i32(x):
    """uint32 words (int64 tensors or ints) as int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)  # keeps the low 32 bits
    x = int(x) & _M
    return x - (1 << 32) if x >= 1 << 31 else x


def _rotl_(x: torch.Tensor, r: int, tmp: torch.Tensor) -> torch.Tensor:
    """Rotate int32 bit patterns left by r, in place (``tmp``: scratch of
    x's shape). The right shift is arithmetic: its sign bits are masked."""
    torch.bitwise_right_shift(x, 32 - r, out=tmp)
    tmp.bitwise_and_((1 << r) - 1)
    return x.bitwise_left_shift_(r).bitwise_or_(tmp)


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block function on broadcastable tensors of
    uint32 words (as ``jax._src.prng._threefry2x32_lowering``). The rounds
    run in place on int32 bit patterns, whose additions wrap like uint32
    ones (half the bytes of int64, no masks, no allocation per operation);
    the outputs are int64 words."""
    k1, k2, x1, x2 = _i32(k1), _i32(k2), _i32(x1), _i32(x2)
    ks = (k1, k2, k1 ^ k2 ^ _i32(0x1BD11BDA))
    x0, y = x1 + ks[0], x2 + ks[1]
    shape = torch.broadcast_shapes(x0.shape, y.shape)
    x0 = x0.expand(shape).contiguous() if x0.shape != shape else x0
    y = y.expand(shape).contiguous() if y.shape != shape else y
    tmp = torch.empty_like(y)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(y)
            _rotl_(y, r, tmp).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        y.add_(ks[(i + 2) % 3]).add_(i + 1)
    return x0.to(torch.int64) & _M, y.to(torch.int64) & _M


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as the JAX package runs it (64-bit mode
    off): the low 32 bits of the seed under a zero high word, for every
    seed in the int64 range; a seed outside it raises ``OverflowError``."""
    seed = int(seed)
    if not -(2**63) <= seed < 2**63:
        raise OverflowError(f"seed {seed} is out of the int64 range")
    # [0, seed] made on the device: a copy from the host would wait for it
    return torch.arange(2, dtype=torch.int64, device=device) * (seed & _M)


def _iota(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat index of every element as (hi, lo) uint32 words."""
    n = math.prod(shape)
    if n < 2**31:  # the high word is 0
        lo = torch.arange(n, dtype=torch.int32, device=device).reshape(tuple(shape))
        return torch.zeros((), dtype=torch.int32, device=device), lo
    flat = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return (flat >> 32) & _M, flat & _M


def _hash(k: torch.Tensor, shape: Sequence[int]):
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota(shape, k.device)
    lead = k.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = k[..., 0].reshape(view)
    k2 = k[..., 1].reshape(view)
    return threefry2x32(k1, k2, hi, lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash(k, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the key over the words (0, data).
    ``data`` must fit a uint32, else ``OverflowError`` (as jax raises)."""
    data = int(data)
    if not 0 <= data <= _M:
        raise OverflowError(f"fold_in data {data} is out of bounds for uint32")
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack([b1, b2], dim=-1)


def bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): (..., *shape)."""
    b1, b2 = _hash(k, shape)
    return b1 ^ b2


def uniform(k, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): the mantissa-fill construction
    of ``jax.random.uniform``, so raw draws are bit-equal."""
    fb = (bits(k, shape) >> 9) | 0x3F800000  # < 2**31: fits int32
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def rademacher(k, shape, dtype=torch.float32) -> torch.Tensor:
    """±1 draws: ``bernoulli(p=0.5)`` is ``uniform < 0.5``, and the uniform
    (the top 23 bits over [1, 2), minus 1) is below 0.5 exactly when the
    draw's top bit is 0, so the sign is read off that bit."""
    top = bits(k, shape) >> 31
    return (1 - 2 * top).to(dtype)


def rademacher_rows(k, block: int, rows: torch.Tensor, d: int, dtype=torch.float32) -> torch.Tensor:
    """Rows of the ±1 matrices ``rademacher(fold_in(k, i), (block, d))``:
    global row f (an int64 tensor (n,)) is row ``f % block`` of block
    ``f // block``. (n, d), equal to those rows of the whole draws (each
    element's bits come from its own counter, so a card can draw its own
    rows alone)."""
    kb1, kb2 = threefry2x32(k[..., 0], k[..., 1], 0, rows // block)  # fold_in, per row
    ctr = (rows % block)[:, None] * d + torch.arange(d, dtype=torch.int64, device=rows.device)
    b1, b2 = threefry2x32(kb1[:, None], kb2[:, None], 0, ctr)
    return (1 - 2 * ((b1 ^ b2) >> 31)).to(dtype)


def normal(k, shape) -> torch.Tensor:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return np.float32(np.sqrt(2)).item() * torch.erfinv(u)


def truncated_normal(k, lower: float, upper: float, shape) -> torch.Tensor:
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32)
    lo = torch.tensor(lower, dtype=torch.float32)
    hi = torch.tensor(upper, dtype=torch.float32)
    a = torch.erf(lo / sqrt2)
    b = torch.erf(hi / sqrt2)
    u = uniform(k, shape, a.to(k.device), b.to(k.device))
    out = sqrt2.to(k.device) * torch.erfinv(u)
    inf = torch.tensor(float("inf"))
    return out.clamp(
        torch.nextafter(lo, inf).item(), torch.nextafter(hi, -inf).item()
    )


def gumbel(k, shape) -> torch.Tensor:
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(k, shape, tiny, 1.0)))


def categorical(k, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-argmax over the last axis of ``logits`` (..., n): one draw per
    key; keys (..., 2) batch against the logits' leading dims."""
    g = gumbel(k, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
