"""State-space and recurrent blocks: Mamba-2 (chunked SSD) and xLSTM's
mLSTM and sLSTM (port of ``repro.models.ssm``).

The chunked SSD algorithm writes the selective scan as block matmuls: an
intra-chunk term (the masked decay matrix ``exp(segsum)`` times ``C·Bᵀ``),
chunk-final states, a short recurrence over the chunks (a Python loop here,
``lax.scan`` in the JAX package) and the inter-chunk term. mLSTM runs
through the same machinery: ``h_t = f_t h_{t-1} + i_t v_t k_tᵀ`` is an SSD
recurrence with decay ``log f`` and input gain ``i``. sLSTM mixes its
recurrent state through weights, so it loops over time; its decode step is
O(1).

Functions on tensors with the JAX package's names, params and caches as
dicts with its keys and layouts (so that weights carry across with
``convert.params_from_numpy``), random draws from ``repro_torch.random``'s
threefry keys. Where the reference casts to float32 (the decays, the gate
pre-activations), this does too. ``max(|n|, 1)`` is ``torch.maximum``
against a one: its gradient at a tie is split in halves, as ``jnp.maximum``
splits it. The sLSTM's first step ties in every element (n = exp(0)),
though there the split reaches no gradient: n's derivative is zero but
through the incoming state, scaled by f ≈ exp(-30).

Covers zamba2-7b (Mamba-2 + a shared attention block) and xlstm-1.3b
(mLSTM + sLSTM).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.models.common import ModelConfig, dense_init, rmsnorm, rmsnorm_init
from repro_torch.utils import spmd


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold, unlike
    ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def _f32_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, where the reference casts to it; float64 (a run that
    measures float32's own error) stays float64."""
    return dtype if dtype == torch.float64 else torch.float32


def _f32(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``astype(float32)`` (see ``_f32_dtype``)."""
    return x.to(_f32_dtype(x.dtype))


def _one(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Chunked SSD core (shared by Mamba-2 and mLSTM)
# ---------------------------------------------------------------------------
def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: ``out[..., i, j] = sum_{j < l <= i} a[..., l]``.

    a: (..., Q). Returns (..., Q, Q), -inf above the diagonal (written with
    ``where`` before any ``exp``, so no ``inf - inf`` reaches a gradient).
    """
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(x, a, B, C, chunk: int):
    """Chunked selective state-space duality scan.

    Recurrence (per head): h_t = exp(a_t) h_{t-1} + B_t x_tᵀ, y_t = C_tᵀ h_t.
    x: (b, l, h, p) per-step inputs (already scaled by dt / the input gate);
    a: (b, l, h) per-step log-decay (<= 0); B, C: (b, l, h, n) input and
    output maps. Returns y (b, l, h, p) and the final state (b, h, n, p).
    ``l`` must be a multiple of ``min(chunk, l)``.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l)
    if l % Q:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {Q}")
    nc = l // Q

    xr = x.reshape(b, nc, Q, h, p).permute(0, 1, 3, 2, 4)  # (b, c, h, Q, p)
    ar = _f32(a.reshape(b, nc, Q, h).permute(0, 1, 3, 2))  # (b, c, h, Q)
    Br = B.reshape(b, nc, Q, h, n).permute(0, 1, 3, 2, 4)  # (b, c, h, Q, n)
    Cr = C.reshape(b, nc, Q, h, n).permute(0, 1, 3, 2, 4)

    a_cum = torch.cumsum(ar, dim=-1)  # (b, c, h, Q)
    a_total = a_cum[..., -1]  # (b, c, h)

    # 1. intra-chunk (diagonal blocks): the masked decay times C·Bᵀ
    L = torch.exp(_segsum(ar))  # (b, c, h, Q, Q)
    scores = _f32(Cr @ Br.transpose(-1, -2))
    y_diag = (scores * L).to(x.dtype) @ xr

    # 2. chunk-final states: decay-to-end weighted input outer products
    decay_end = torch.exp(a_total[..., None] - a_cum)  # (b, c, h, Q)
    states = (Br * decay_end.to(x.dtype)[..., None]).transpose(-1, -2) @ xr  # (b, c, h, n, p)

    # 3. the recurrence over chunk states; emits the state entering each chunk
    decay = torch.exp(a_total).to(x.dtype)  # (b, c, h)
    carry = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, c, h, n, p)

    # 4. the inter-chunk term: (C ⊙ decay_in) @ the state entering the chunk
    decay_in = torch.exp(a_cum)  # (b, c, h, Q)
    y_off = (Cr * decay_in.to(x.dtype)[..., None]) @ prev_states

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, l, h, p)
    return y, carry


def ssd_step(state, x, a, B, C):
    """Single-token recurrent step (decode path).

    state: (b, h, n, p); x: (b, h, p); a: (b, h); B, C: (b, h, n).
    """
    state = state * torch.exp(_f32(a))[..., None, None].to(state.dtype)
    state = state + B[..., :, None] * x[..., None, :]
    y = (C[..., None, :] @ state)[..., 0, :]
    return y, state


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------
def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_inner // 64)
    P = d_inner // H
    N = cfg.ssm_state
    return d_inner, H, P, N


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace`` in float32, in its form: ``start·(1 − s) + stop·s``
    with ``s = i / (num − 1)``, and ``stop`` itself last. Equal to it at
    small ``num``; at 112 (zamba2-7b's heads) XLA's division on the CPU
    rounds some ``s`` differently, and a third of the values differ by an
    ulp (``torch.linspace``'s ramp differs more)."""
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def mamba2_init(key, cfg: ModelConfig):
    d_inner, H, P, N = mamba2_dims(cfg)
    conv_ch = d_inner + 2 * N
    dev = key.device
    k_in, k_conv, k_dt, k_out = rnd.split(key, 4)
    return {
        "norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
        # order: [z (gate), x, B, C, dt]
        "w_in": dense_init(k_in, (cfg.d_model, 2 * d_inner + 2 * N + H), cfg.dtype),
        "conv_w": dense_init(k_conv, (cfg.ssm_conv, conv_ch), cfg.dtype, scale=0.5),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "A_log": torch.log(_linspace(1.0, 16.0, H, dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "gated_norm": rmsnorm_init(d_inner, cfg.dtype, dev),
        "w_out": dense_init(k_out, (d_inner, cfg.d_model), cfg.dtype),
    }


def _causal_conv(seq, w, carry=None):
    """Depthwise causal conv. seq: (b, l, ch); w: (kw, ch); carry: (b, kw-1,
    ch), the inputs before ``seq`` (zeros when not given). Returns
    (silu(out), the new carry)."""
    kw = w.shape[0]
    if carry is None:
        carry = torch.zeros((seq.shape[0], kw - 1, seq.shape[2]), dtype=seq.dtype, device=seq.device)
    padded = torch.cat([carry, seq], dim=1)
    out = sum(padded[:, i:i + seq.shape[1]] * w[i] for i in range(kw))
    new_carry = padded[:, -(kw - 1):] if kw > 1 else carry
    return F.silu(out), new_carry


def _mamba2_in(params, cfg: ModelConfig, x, conv_carry=None):
    """Norm, input projection and causal conv of a Mamba-2 block: z, x, B,
    C, dt (float32, after softplus), the log-decay a, the conv carry."""
    d_inner, H, P, N = mamba2_dims(cfg)
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    zxbcdt = h @ params["w_in"]
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)
    conv_out, new_carry = _causal_conv(torch.cat([xin, Bc, Cc], dim=-1), params["conv_w"], conv_carry)
    xin, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = _softplus(_f32(dt) + params["dt_bias"])  # (b, l, H)
    a = dt * -torch.exp(params["A_log"])  # (b, l, H) log decay
    return z, xin, Bc, Cc, dt, a, new_carry


def _mamba2_out(params, cfg: ModelConfig, x, y, z):
    """Gated norm of y (b, l, d_inner) and the output projection, added to x."""
    y = rmsnorm(params["gated_norm"], y * F.silu(z), cfg.norm_eps)
    return x + y @ params["w_out"]


def mamba2_apply(params, cfg: ModelConfig, x):
    """x: (B, L, D) -> (B, L, D). Training path (chunked SSD)."""
    if spmd.is_dtensor(x):  # no split over 'model': each card runs the whole layer
        return spmd.whole_layer(lambda p, x: mamba2_apply(p, cfg, x), params, x)
    d_inner, H, P, N = mamba2_dims(cfg)
    z, xin, Bc, Cc, dt, a, _ = _mamba2_in(params, cfg, x)
    b, l, _ = x.shape
    xh = xin.reshape(b, l, H, P)
    Bh = Bc[:, :, None, :].expand(b, l, H, N)
    Ch = Cc[:, :, None, :].expand(b, l, H, N)
    y, _ = ssd_chunked(xh * dt[..., None].to(x.dtype), a, Bh, Ch, cfg.ssm_chunk)
    y = y + xh * params["D"][None, None, :, None].to(x.dtype)
    return _mamba2_out(params, cfg, x, y.reshape(b, l, d_inner), z)


def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype=None, device=None) -> Dict[str, torch.Tensor]:
    d_inner, H, P, N = mamba2_dims(cfg)
    dtype = dtype or cfg.dtype
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * N), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=dtype, device=device),
    }


def mamba2_decode(params, cfg: ModelConfig, x, cache):
    """x: (B, 1, D); O(1) recurrent update. Returns (out, new cache)."""
    if spmd.is_dtensor(x):  # no split over 'model': each card runs the whole layer
        return spmd.whole_layer(lambda p, x, c: mamba2_decode(p, cfg, x, c), params, x, cache)
    d_inner, H, P, N = mamba2_dims(cfg)
    z, xin, Bc, Cc, dt, a, new_conv = _mamba2_in(params, cfg, x, cache["conv"])
    b = x.shape[0]
    xin, Bc, Cc, dt, a = xin[:, 0], Bc[:, 0], Cc[:, 0], dt[:, 0], a[:, 0]
    xh = xin.reshape(b, H, P) * dt[..., None].to(x.dtype)
    Bh = Bc[:, None, :].expand(b, H, N).to(x.dtype)
    Ch = Cc[:, None, :].expand(b, H, N).to(x.dtype)
    y, new_ssm = ssd_step(cache["ssm"], xh, a, Bh, Ch)
    y = y + xin.reshape(b, H, P) * params["D"][None, :, None].to(x.dtype)
    out = _mamba2_out(params, cfg, x, y.reshape(b, 1, d_inner), z)
    return out, {"conv": new_conv, "ssm": new_ssm}


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM's matrix memory), through the SSD machinery
# ---------------------------------------------------------------------------
def mlstm_init(key, cfg: ModelConfig):
    nh = cfg.n_heads
    dev = key.device
    k_q, k_k, k_v, k_g, k_o, k_u, k_d2 = rnd.split(key, 7)
    d_up = cfg.ssm_expand * cfg.d_model
    hd_up = d_up // nh
    return {
        "norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
        "w_up": dense_init(k_u, (cfg.d_model, 2 * d_up), cfg.dtype),
        # per-head block-diagonal projections: q/k/v mix only within a head
        "wq": dense_init(k_q, (nh, hd_up, hd_up), cfg.dtype),
        "wk": dense_init(k_k, (nh, hd_up, hd_up), cfg.dtype),
        "wv": dense_init(k_v, (nh, hd_up, hd_up), cfg.dtype),
        "w_gates": dense_init(k_g, (d_up, nh, 2), torch.float32),  # (i, f) pre-activations
        "out_norm": rmsnorm_init(d_up, cfg.dtype, dev),
        "w_down": dense_init(k_d2, (d_up, cfg.d_model), cfg.dtype),
    }


def _mlstm_qkvg(params, cfg: ModelConfig, h):
    nh = cfg.n_heads
    up = h @ params["w_up"]
    u, gate = torch.chunk(up, 2, dim=-1)
    b, l = u.shape[:2]
    uh = u.reshape(b, l, nh, -1)  # (b, l, nh, hd_up)
    q = torch.einsum("blhe,hek->blhk", uh, params["wq"])
    k = torch.einsum("blhe,hek->blhk", uh, params["wk"]) / math.sqrt(q.shape[-1])
    v = torch.einsum("blhe,hek->blhk", uh, params["wv"])
    u32 = _f32(u)
    pre = torch.einsum("ble,ehg->blhg", u32, params["w_gates"].to(u32.dtype))
    # stabilized gates: a sigmoid input gate (the reference's soft-capped
    # exponential gate) and a log-sigmoid forget decay
    ig = torch.sigmoid(pre[..., 0])  # (b, l, nh)
    a = _log_sigmoid(pre[..., 1])  # (b, l, nh) log decay <= 0
    return q, k, v, ig, a, gate


def _mlstm_out(params, cfg: ModelConfig, x, y, gate):
    y = y.reshape(x.shape[0], x.shape[1], -1)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * F.silu(gate)
    return x + y @ params["w_down"]


def mlstm_apply(params, cfg: ModelConfig, x):
    """x: (B, L, D) -> (B, L, D): numerator and denominator as two chunked
    SSD scans, ``num / max(|den|, 1)``."""
    if spmd.is_dtensor(x):  # no split over 'model': each card runs the whole layer
        return spmd.whole_layer(lambda p, x: mlstm_apply(p, cfg, x), params, x)
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    q, k, v, ig, a, gate = _mlstm_qkvg(params, cfg, h)
    gain = ig[..., None].to(v.dtype)
    num, _ = ssd_chunked(v * gain, a, k, q, cfg.ssm_chunk)  # (b, l, h, p)
    den, _ = ssd_chunked(torch.ones_like(v[..., :1]) * gain, a, k, q, cfg.ssm_chunk)
    y = num / torch.maximum(torch.abs(den), _one(den))
    return _mlstm_out(params, cfg, x, y, gate)


def mlstm_cache_init(cfg: ModelConfig, batch: int, dtype=None, device=None) -> Dict[str, torch.Tensor]:
    nh = cfg.n_heads
    hd = (cfg.d_model // nh) * cfg.ssm_expand
    dtype = dtype or cfg.dtype
    return {
        "C": torch.zeros((batch, nh, hd, hd), dtype=dtype, device=device),  # (b, h, n = k, p = v)
        "n": torch.zeros((batch, nh, hd, 1), dtype=dtype, device=device),
    }


def mlstm_decode(params, cfg: ModelConfig, x, cache):
    if spmd.is_dtensor(x):  # no split over 'model': each card runs the whole layer
        return spmd.whole_layer(lambda p, x, c: mlstm_decode(p, cfg, x, c), params, x, cache)
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    q, k, v, ig, a, gate = _mlstm_qkvg(params, cfg, h)
    q, k, v, ig, a = q[:, 0], k[:, 0], v[:, 0], ig[:, 0], a[:, 0]
    num, newC = ssd_step(cache["C"], v * ig[..., None].to(v.dtype), a, k, q)
    den, newn = ssd_step(cache["n"], (ig[..., None] * torch.ones_like(v[..., :1])).to(v.dtype), a, k, q)
    y = num / torch.maximum(torch.abs(den), _one(den))
    return _mlstm_out(params, cfg, x, y, gate), {"C": newC, "n": newn}


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, recurrent mixing: a loop over time)
# ---------------------------------------------------------------------------
def slstm_init(key, cfg: ModelConfig):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    dev = key.device
    k_w, k_r, k_f, k_o = rnd.split(key, 4)
    d_ff = int(cfg.d_model * 4 / 3 / 2) * 2  # GLU FFN at a 4/3 projection factor
    return {
        "norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
        # input projections for (i, f, z, o)
        "w": dense_init(k_w, (cfg.d_model, nh, 4, hd), cfg.dtype),
        # head-wise recurrent mixing for (i, f, z, o)
        "r": dense_init(k_r, (nh, 4, hd, hd), cfg.dtype, scale=0.4),
        "out_norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
        "ffn_norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
        "ffn_up": dense_init(k_f, (cfg.d_model, 2 * d_ff), cfg.dtype),
        "ffn_down": dense_init(k_o, (d_ff, cfg.d_model), cfg.dtype),
    }


def _r_matrix(r: torch.Tensor) -> torch.Tensor:
    """(nh, 4, hd, hd) -> (nh, hd, 4·hd): the recurrent weights laid out
    once for a per-head ``bmm`` (einsum would permute them every step)."""
    nh, g, hd, _ = r.shape
    return r.permute(0, 2, 1, 3).reshape(nh, hd, g * hd)


def _slstm_step(r_mat, wx, state):
    """One sLSTM time step on ``_r_matrix`` weights; see ``slstm_cell``."""
    c, n, m, hprev = state["c"], state["n"], state["m"], state["h"]
    b, nh, hd = hprev.shape
    rx = torch.bmm(hprev.transpose(0, 1), r_mat.to(hprev.dtype)).reshape(nh, b, 4, hd).transpose(0, 1)  # (b, nh, 4, hd)
    pre = _f32(wx) + _f32(rx)
    i_pre, f_pre, z_pre, o_pre = pre.unbind(2)
    # stabilizer state m (the xLSTM paper's log-space max)
    log_f = _log_sigmoid(f_pre)
    lfm = log_f + m
    m_new = torch.maximum(lfm, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(lfm - m_new)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.maximum(torch.abs(n_new), _one(n_new))
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def slstm_cell(params_r, wx, state):
    """One sLSTM time step. params_r: (nh, 4, hd, hd); wx: (b, nh, 4, hd)
    input pre-activations; state: c, n, m, h (b, nh, hd) float32."""
    return _slstm_step(_r_matrix(params_r), wx, state)


def slstm_state_init(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    z = torch.zeros((batch, nh, hd), dtype=_f32_dtype(cfg.dtype), device=device)
    return {"c": z, "n": z, "m": z - 30.0, "h": z}


def _slstm_ffn(params, cfg: ModelConfig, x, y):
    """The block after the cell: out-norm residual, then the GLU FFN."""
    x = x + rmsnorm(params["out_norm"], y.to(x.dtype), cfg.norm_eps)
    f = rmsnorm(params["ffn_norm"], x, cfg.norm_eps) @ params["ffn_up"]
    f1, f2 = torch.chunk(f, 2, dim=-1)
    return x + (F.silu(f1) * f2) @ params["ffn_down"]


def _wx(params, cfg: ModelConfig, x):
    """Input pre-activations (b, l, nh, 4, hd)."""
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    w = params["w"]
    return (h @ w.reshape(w.shape[0], -1)).reshape(x.shape[:2] + tuple(w.shape[1:]))


def slstm_apply(params, cfg: ModelConfig, x):
    """x: (B, L, D) -> (B, L, D): the cell over time, then the GLU FFN."""
    if spmd.is_dtensor(x):  # no split over 'model': each card runs the whole layer
        return spmd.whole_layer(lambda p, x: slstm_apply(p, cfg, x), params, x)
    b, l, d = x.shape
    wx = _wx(params, cfg, x)
    r_mat = _r_matrix(params["r"])
    state = slstm_state_init(cfg, b, x.device)
    hs = []
    for t in range(l):
        state = _slstm_step(r_mat, wx[:, t], state)
        hs.append(state["h"])
    return _slstm_ffn(params, cfg, x, torch.stack(hs, dim=1).reshape(b, l, d))


def slstm_decode(params, cfg: ModelConfig, x, cache):
    if spmd.is_dtensor(x):  # no split over 'model': each card runs the whole layer
        return spmd.whole_layer(lambda p, x, c: slstm_decode(p, cfg, x, c), params, x, cache)
    new = slstm_cell(params["r"], _wx(params, cfg, x)[:, 0], cache)
    return _slstm_ffn(params, cfg, x, new["h"].reshape(x.shape[0], 1, -1)), new
