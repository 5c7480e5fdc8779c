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

Bounded draws: every draw is made ``CHUNK`` values at a time, so its
temporaries are bounded by the chunk and not by the leaf (a (128, 5120,
8192) expert leaf needs 21.5 GB of output and ~0.34 GB besides); a draw of
one piece is returned as made, a larger one is written piece by piece into
a preallocated output (or the caller's ``out``). Every element's bits come
from its own counter, the global flat index ``i`` as the words
``(i >> 32, i & 0xFFFFFFFF)``, so a chunk, or a card's block of a leaf
(``shard=Shard(local_shape, offsets)``, drawn in row-major runs along the
last dim; ``block_index`` lists its counters), is bit-equal to those
elements of the whole draw.
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

# values a draw holds temporaries for at a time, a multiple of 64 (~24
# bytes each at the peak of a normal draw); a sketch block of 2**16 rows x
# 256 is one piece
CHUNK = 1 << 24
# values erfinv transforms at a time (its float64 steps hold ~60 bytes a
# value), so an ``xla_normal`` draw's peak stays near the threefry words' own
_ERFINV_PIECE = 1 << 22


class Shard(NamedTuple):
    """A card's block of a leaf: ``local_shape`` elements from ``offsets``
    on, one entry per dim of the leaf."""
    local_shape: Tuple[int, ...]
    offsets: Tuple[int, ...]

    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(o, o + n) for o, n in zip(self.offsets, self.local_shape))


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
    x0, y = _threefry_i32(k1, k2, x1, x2)
    return x0.to(torch.int64) & _M, y.to(torch.int64) & _M


def _threefry_i32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """``threefry2x32`` with its outputs left as int32 bit patterns."""
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
    return x0, y


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
    if k.is_meta:  # shapes only (``Model.init_shapes``): no arithmetic
        out = torch.empty(tuple(k.shape[:-1]) + shape, dtype=torch.int64, device="meta")
        return out, out
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


def _pieces(shape: Tuple[int, ...], shard: Optional[Shard], per: int,
            device) -> Iterator[Tuple[int, int, object, torch.Tensor]]:
    """(start, stop, hi, lo): the output's flat positions [start, stop), at
    most ``per`` of them, and their counters' (hi, lo) words: positions of
    the whole leaf, or of a shard (whole rows of it at a time, or pieces of
    one row longer than ``per``)."""
    if shard is None:
        n = math.prod(shape)
        for a in range(0, n, per):
            b = min(a + per, n)
            if b <= 2**31:  # the high word is 0
                yield a, b, 0, torch.arange(a, b, dtype=torch.int32, device=device)
            else:
                yield (a, b) + _words(torch.arange(a, b, dtype=torch.int64, device=device))
        return
    shape, local, off = _dims(shape, shard)
    L, rows = local[-1], math.prod(local[:-1])
    cols = torch.arange(off[-1], off[-1] + min(L, per), dtype=torch.int64, device=device)
    if L <= per:
        step = per // L
        for r0 in range(0, rows, step):
            r1 = min(r0 + step, rows)
            starts = _row_starts(shape, local, off, torch.arange(r0, r1, dtype=torch.int64, device=device))
            yield (r0 * L, r1 * L) + _words((starts[:, None] + cols).reshape(-1))
        return
    for r in range(rows):
        start = int(_row_starts(shape, local, off, torch.tensor([r], dtype=torch.int64))[0])
        for c in range(0, L, per):
            m = min(per, L - c)
            yield (r * L + c, r * L + c + m) + _words(cols[:m] + (start + c))


def _dims(shape, shard: Shard):
    """(leaf shape, block shape, block offsets), a scalar as one element."""
    return tuple(shape) or (1,), tuple(shard.local_shape) or (1,), tuple(shard.offsets) or (0,)


def _row_starts(shape, local, off, r: torch.Tensor) -> torch.Tensor:
    """Global flat index of the first element of the shard's local rows
    ``r`` (row-major over ``local[:-1]``)."""
    start = torch.zeros_like(r)
    stride = shape[-1]
    for d in range(len(shape) - 2, -1, -1):
        start += (r % local[d] + off[d]) * stride
        r = r // local[d]
        stride *= shape[d]
    return start


def block_index(shape: Sequence[int], shard: Shard, device=None) -> torch.Tensor:
    """The global flat (row-major) indices of the block ``shard`` of a
    ``shape`` leaf, in the block's own row-major order (ascending): the
    counters a draw of the block uses."""
    shape, local, off = _dims(tuple(int(s) for s in shape), shard)
    rows = torch.arange(math.prod(local[:-1]), dtype=torch.int64, device=device)
    cols = torch.arange(off[-1], off[-1] + local[-1], dtype=torch.int64, device=device)
    return (_row_starts(shape, local, off, rows)[:, None] + cols).reshape(-1)


def _words(idx: torch.Tensor):
    """int64 counters as their (hi, lo) words (int32 bit patterns)."""
    return (idx >> 32).to(torch.int32), idx.to(torch.int32)


def _draw(k: torch.Tensor, shape, fn: Callable, dtype, shard: Optional[Shard] = None,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fn`` of the 32 random bits of every element of a ``shape`` draw per
    key of ``k`` (..., 2), as ``dtype``: the whole draw (..., *shape) or the
    block ``shard`` of it (..., *shard.local_shape). Made piece by piece,
    each piece's bits made and transformed alone: a draw of one piece is
    returned as made, else the pieces go into ``out`` (allocated when not
    given)."""
    shape = tuple(int(s) for s in shape)
    lead = tuple(k.shape[:-1])
    part = shape if shard is None else tuple(int(s) for s in shard.local_shape)
    m, n = math.prod(lead), math.prod(part)
    if out is not None and (tuple(out.shape) != lead + part or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} is not a contiguous {lead + part} tensor")
    if k.is_meta or m * n == 0:  # shapes only, or nothing to draw
        return torch.empty(lead + part, dtype=dtype, device=k.device) if out is None else out
    k1, k2 = k[..., 0].reshape(m, 1), k[..., 1].reshape(m, 1)
    per = max(64, CHUNK // m // 64 * 64)
    flat = None if out is None else out.view(m, n)
    for a, b, hi, lo in _pieces(shape, shard, per, k.device):
        x0, y = _threefry_i32(k1, k2, hi, lo)
        del hi, lo
        b32 = x0.bitwise_xor_(y)
        del x0, y
        if flat is None:
            if b - a == n:  # one piece
                return fn(b32).to(dtype).reshape(lead + part)
            out = torch.empty(lead + part, dtype=dtype, device=k.device)
            flat = out.view(m, n)
        flat[:, a:b].copy_(fn(b32))
        del b32
    return out


def _u32(b: torch.Tensor) -> torch.Tensor:
    """32 random bits as int64 words (int32 bit patterns widened)."""
    return b if b.dtype == torch.int64 else b.to(torch.int64) & _M


def bits(k: torch.Tensor, shape: Sequence[int], *, shard: Optional[Shard] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): (..., *shape), or
    its block ``shard`` (``_draw``)."""
    return _draw(k, shape, _u32, torch.int64, shard, out)


def _uniform_of(b: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The mantissa-fill construction of ``jax.random.uniform`` on 32 random
    bits (int64 words or int32 patterns): the top 23 bits over [1, 2)."""
    fb = ((b >> 9) & 0x7FFFFF) | 0x3F800000  # < 2**31: fits int32
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(k, shape, minval=0.0, maxval=1.0, *, shard: Optional[Shard] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): the mantissa-fill construction
    of ``jax.random.uniform``, so raw draws are bit-equal."""
    lo = torch.as_tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=k.device)
    return _draw(k, shape, lambda b: _uniform_of(b, lo, hi), torch.float32, shard, out)


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


# XLA's float32 erf_inv (Giles' single-precision polynomial in
# w = -log1p(-x^2), split at w = 5), with the log1p and log that XLA emits on
# the CPU (Cephes' rational log1p below sqrt(2) - 1, else log(1 + x);
# Cephes' logf) and the multiply-adds it fuses. torch.erfinv is another
# approximation: on two thirds of the uniforms it differs from XLA's by up
# to 1.5e-5.
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
           -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _f32(c: float) -> float:
    return float(np.float32(c))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once (a float64 product of float32s is exact;
    the sum is rounded to float64, then to float32)."""
    t = a.double().mul_(b if isinstance(b, float) else b.double())
    return t.add_(c if isinstance(c, float) else c.double()).float()


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(c))
    return p


def _logf(v: torch.Tensor) -> torch.Tensor:
    """Cephes' logf for v > 0 (normal floats), as XLA emits it."""
    bits = v.view(torch.int32)
    e = (bits >> 23).float().sub_(126.0)
    x = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = x < _f32(0.707106781186547524)
    e.sub_(small.float())
    x = (x - 1.0).add_(torch.where(small, x, 0.0))
    x2 = x * x
    x3 = x2 * x
    p = _LOGF_P
    y = _fma(_fma(x, _f32(p[0]), _f32(p[1])), x, _f32(p[2]))
    y1 = _fma(_fma(x, _f32(p[3]), _f32(p[4])), x, _f32(p[5]))
    y2 = _fma(_fma(x, _f32(p[6]), _f32(p[7])), x, _f32(p[8]))
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4))
    x = (x - x2 * 0.5).add_(y)
    return x.add_(e * 0.693359375)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's log1p for x > -1."""
    x2 = x * x
    s = _poly(x, _LOG1P_NUM).div_(_poly(x, _LOG1P_DEN))
    s = _fma(x2, -0.5, (x * x2).mul_(s)).add_(x)
    return torch.where(x.abs() < _f32(0.41421356237309504880), s, _logf(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv on (-1, 1) as XLA computes it on the CPU
    (``jax.lax.erf_inv``): bit-equal to it but for 1 ulp on ~2e-5 of the
    uniforms (|x| > 0.9966, where XLA's float32 sqrt is not correctly
    rounded). Every step is IEEE arithmetic, so the card and the CPU agree
    bit for bit. Made ``_ERFINV_PIECE`` values at a time (its float64 steps
    hold ~60 bytes a value)."""
    if x.numel() <= _ERFINV_PIECE:
        return _erfinv(x)
    out = torch.empty_like(x)
    src, dst = x.reshape(-1), out.view(-1)
    for i in range(0, src.numel(), _ERFINV_PIECE):
        dst[i:i + _ERFINV_PIECE] = _erfinv(src[i:i + _ERFINV_PIECE])
    return out


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = _log1p(x * -x).neg_()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    c = [torch.where(lt, _f32(a), _f32(b)) for a, b in zip(_ERFINV_W_LT5, _ERFINV_W_GE5)]
    p = c[0]
    for ci in c[1:]:
        p = _fma(p, w, ci)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k, shape, *, scale: Optional[float] = None, dtype=torch.float32, shard: Optional[Shard] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard normals (``jax.random.normal``: ``sqrt(2)·erfinv`` of a
    uniform in (-1, 1)), times ``scale`` when given, as ``dtype``."""
    lo = torch.as_tensor(float(np.nextafter(np.float32(-1.0), np.float32(0.0))), dtype=torch.float32,
                         device=k.device)
    hi = torch.as_tensor(1.0, dtype=torch.float32, device=k.device)
    sqrt2 = np.float32(np.sqrt(2)).item()

    def fn(b):
        out = sqrt2 * torch.erfinv(_uniform_of(b, lo, hi))
        return out if scale is None else out * scale

    return _draw(k, shape, fn, dtype, shard, out)


def xla_normal(k, shape, *, dtype=torch.float32) -> torch.Tensor:
    """Standard normals bit-equal to ``jax.random.normal`` on the CPU but for
    1-2 ulp on ~2e-5 of the tails: ``normal``'s uniforms through XLA's
    erf_inv (``erfinv``). Local DP's noise draws with it: sigma x clip of
    noise lands on every element of every delta every round, and torch's
    erfinv there carried a 12-round run 2.8e-5 from the reference's (its own
    float32-vs-float64 gap: 2.5e-7). ``normal`` keeps torch's erfinv (the
    inits' one draw, a few ulp from XLA's; the XLA path's float64 steps
    make a draw ~3x slower)."""
    lo = torch.as_tensor(float(np.nextafter(np.float32(-1.0), np.float32(0.0))), dtype=torch.float32,
                         device=k.device)
    hi = torch.as_tensor(1.0, dtype=torch.float32, device=k.device)
    sqrt2 = np.float32(np.sqrt(2)).item()
    return _draw(k, shape, lambda b: sqrt2 * erfinv(_uniform_of(b, lo, hi)), dtype)


def truncated_normal(k, lower: float, upper: float, shape, *, scale: Optional[float] = None,
                     dtype=torch.float32, shard: Optional[Shard] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normals truncated to (lower, upper) (``jax.random.truncated_normal``:
    ``sqrt(2)·erfinv`` of a uniform between the bounds' ``erf``), times
    ``scale`` when given, as ``dtype``."""
    if k.is_meta:
        return _draw(k, shape, None, dtype, shard, out)
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32)
    lo = torch.tensor(lower, dtype=torch.float32)
    hi = torch.tensor(upper, dtype=torch.float32)
    a = torch.erf(lo / sqrt2).to(k.device)
    b = torch.erf(hi / sqrt2).to(k.device)
    inf = torch.tensor(float("inf"))
    cl, ch = torch.nextafter(lo, inf).item(), torch.nextafter(hi, -inf).item()
    sqrt2 = sqrt2.to(k.device)

    def fn(bits_):
        out = (sqrt2 * torch.erfinv(_uniform_of(bits_, a, b))).clamp(cl, ch)
        return out if scale is None else out * scale

    return _draw(k, shape, fn, dtype, shard, out)


def randint(k, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 integers in [minval, maxval): ``jax.random.randint`` with its
    default dtype, draw for draw. Two 32-bit draws per element (of the
    key's two halves, ``split``) are combined mod the span as jax combines
    them: ``((hi % span) * mult + lo % span) % span`` with ``mult =
    (2**16 % span)**2 % span``, in uint32 arithmetic (every product and sum
    wraps at 2**32, the multiplier's square too). ``maxval <= minval``
    gives ``minval``."""
    lo_i, hi_i = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    minval, maxval = int(minval), int(maxval)
    if not (lo_i <= minval <= hi_i and lo_i <= maxval <= hi_i):
        raise ValueError(f"randint bounds [{minval}, {maxval}) lie outside int32")
    k1, k2 = split(k)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & _M if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & _M) % span
    off = ((((hi % span) * mult) & _M) + lo % span) & _M
    return (minval + off % span).to(torch.int32)


def gumbel(k, shape) -> torch.Tensor:
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(k, shape, tiny, 1.0)))


def categorical(k, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-argmax over the last axis of ``logits`` (..., n): one draw per
    key; keys (..., 2) batch against the logits' leading dims."""
    g = gumbel(k, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
