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


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block function on broadcastable int64
    tensors of uint32 words (as ``jax._src.prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M, (x2 + ks[1]) & _M]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M
    return x[0], x[1]


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``: a 32-bit seed pads with a zero high word."""
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**31 else (seed >> 32) & _M
    return torch.tensor([hi, seed & _M], dtype=torch.int64, device=device)


def _iota(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat index of every element as (hi, lo) uint32 words."""
    n = math.prod(shape)
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
    """``jax.random.fold_in``: threefry of the key over the words (0, data)."""
    d = torch.tensor(int(data) & _M, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
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
    """±1 draws: ``bernoulli(p=0.5)`` is ``uniform < 0.5``."""
    u = uniform(k, shape)
    return (2 * (u < 0.5).to(dtype) - 1).to(dtype)


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
