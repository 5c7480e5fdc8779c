"""Shared model building blocks: the attention families' part of
``repro.models.common``.

Every block is ``init(key, cfg) -> params`` plus ``apply(params, x, ...)``.
Params are nested dicts of tensors with the JAX package's keys and layouts
(``wq`` is (D, H, hd), ``wo`` (H, hd, D), ...), so that weights carry across
with ``convert.params_from_numpy``. Random draws follow the JAX package's
threefry key splits exactly (``repro_torch.random``), so both packages draw
the same weights from the same seed.

Stacked params: every apply function also takes params with a leading row
axis (R, ...) together with an input that leads with the same R. Each row
then uses its own weights, and the matmuls over them run as one
``torch.bmm``: the port's form of the JAX package's ``vmap`` over bank rows.

Supported: RMSNorm, SwiGLU / GELU MLPs, GQA projections with RoPE,
Qwen2-VL's M-RoPE and qk_norm, the training attention (causal, optionally
sliding-window, in query chunks under activation checkpointing) and the
single-token decode against a (ring) KV cache. The MoE layer is
``models/moe.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random as rnd

LATER = "later port slice"


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config object drives every architecture in the zoo (the JAX
    package's fields; ``dtype`` is a torch dtype)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention variants
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    sliding_window: int = 0  # 0 -> full causal attention
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = ()  # Qwen2-VL M-RoPE (t, h, w)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_interleave: int = 1  # every `i`-th layer is MoE (1 = all, 2 = alternate)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_group: int = 256  # tokens per routing group

    # SSM / hybrid / xLSTM
    ssm_state: int = 0  # Mamba2 state dim N
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0  # zamba2: shared attention block applied every k layers
    slstm_every: int = 0  # xlstm: one sLSTM per `k` blocks (others mLSTM)

    # attention/CE chunking (memory): query-block size for training
    # attention (0 = dense S×S), token-chunk for the cross-entropy head
    attn_qchunk: int = 512
    ce_chunk: int = 1024

    # audio (musicgen): number of parallel codebooks
    n_codebooks: int = 0

    # vlm: number of image patch positions reserved at sequence start
    vision_patches: int = 0

    gated_mlp: bool = True  # SwiGLU; False = plain GELU MLP (starcoder2)
    # pad the vocab to this size (0 = off); pad logits are masked to -1e30
    vocab_pad: int = 0
    # remat policy of the JAX package's training stack ("full" | "outputs")
    remat_policy: str = "full"
    norm_eps: float = 1e-5
    # the JAX package's scan-vs-unroll switch (the port always loops)
    unroll: bool = False
    tie_embeddings: bool = False
    dtype: Any = torch.float32

    # citation for the assigned-architecture table
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe_arch(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        return max(self.vocab, self.vocab_pad)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Initializers (draws on the key's device)
# ---------------------------------------------------------------------------
def dense_init(key, shape, dtype=torch.float32, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LLM init schemes)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (rnd.truncated_normal(key, -2.0, 2.0, shape) * std).to(dtype)


def embed_init(key, shape, dtype) -> torch.Tensor:
    return (rnd.normal(key, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Stacked-row helpers
# ---------------------------------------------------------------------------
def _dot(x: torch.Tensor, w: torch.Tensor, k: int, stacked: bool) -> torch.Tensor:
    """Contract the last ``k`` axes of x with the first ``k`` axes of w (after
    w's row axis when ``stacked``: then x leads with the same rows and every
    row multiplies its own weights in one ``torch.bmm``)."""
    if stacked:
        R = w.shape[0]
        w_in, w_out = w.shape[1:1 + k], w.shape[1 + k:]
        n_in = math.prod(w_in)
        lead = x.shape[1:x.dim() - k]
        y = torch.bmm(x.reshape(R, -1, n_in), w.reshape(R, n_in, -1))
        return y.reshape((R,) + tuple(lead) + tuple(w_out))
    w_in, w_out = w.shape[:k], w.shape[k:]
    n_in = math.prod(w_in)
    lead = x.shape[:x.dim() - k]
    return (x.reshape(-1, n_in) @ w.reshape(n_in, -1)).reshape(tuple(lead) + tuple(w_out))


def _rows(p: torch.Tensor, x: torch.Tensor, base: int) -> torch.Tensor:
    """Broadcast a per-row leaf (R, *tail) of a stacked ``base``-dim leaf
    against x (R, ..., *tail); an unstacked leaf is returned as it is."""
    if p.dim() == base:
        return p
    return p.reshape(p.shape[:1] + (1,) * (x.dim() - p.dim()) + p.shape[1:])


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_init(dim, dtype, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * _rows(params["scale"], x, 1).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (..., S, H, hd); positions: (..., 3, S)
    for the (t, h, w) ids. The hd/2 frequency channels are split into
    ``sections`` (t, h, w); each section rotates by its own position
    stream. [arXiv:2409.12191]"""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to hd/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles_all = positions[..., None].float() * freqs  # (..., 3, S, hd/2)
    # each channel's angle from its section's stream (the JAX package's
    # one-hot product picks the same values)
    sec_ids = torch.repeat_interleave(torch.arange(3, device=x.device),
                                      torch.tensor(sections, device=x.device))
    angles = angles_all.movedim(-3, -1)[..., torch.arange(hd // 2, device=x.device), sec_ids]
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def default_positions(cfg: ModelConfig, batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """(batch, seq) int32 positions ``arange(seq) + offset``; ``offset`` is
    a scalar or a (batch, 1) tensor (one start per sequence). With M-RoPE,
    (batch, 3, seq): the same ids in each of the (t, h, w) streams."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = torch.broadcast_to(pos.to(torch.int32), (batch, seq))
    if cfg.mrope_sections:
        return torch.broadcast_to(pos[:, None, :], (batch, 3, seq))
    return pos


# ---------------------------------------------------------------------------
# Attention projections (GQA)
# ---------------------------------------------------------------------------
def attention_init(key, cfg: ModelConfig):
    hd = cfg.hd
    k_q, k_k, k_v, k_o = rnd.split(key, 4)
    p = {
        "wq": dense_init(k_q, (cfg.d_model, cfg.n_heads, hd), cfg.dtype),
        "wk": dense_init(k_k, (cfg.d_model, cfg.n_kv_heads, hd), cfg.dtype),
        "wv": dense_init(k_v, (cfg.d_model, cfg.n_kv_heads, hd), cfg.dtype),
        "wo": dense_init(k_o, (cfg.n_heads, hd, cfg.d_model), cfg.dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, cfg.dtype, key.device)
        p["k_norm"] = rmsnorm_init(hd, cfg.dtype, key.device)
    return p


def _rotate(cfg: ModelConfig, x, positions):
    if cfg.mrope_sections:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _qkv(params, cfg: ModelConfig, x, positions):
    """x: (B, S, D) -> q (B, S, H, hd), k, v (B, S, Hkv, hd); with stacked
    params x is (R, ..., S, D) and the outputs lead with R too."""
    stacked = params["wq"].dim() == 4
    q = _dot(x, params["wq"], 1, stacked)
    k = _dot(x, params["wk"], 1, stacked)
    v = _dot(x, params["wv"], 1, stacked)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = _rotate(cfg, q, positions)
    k = _rotate(cfg, k, positions)
    return q, k, v


def attention_out(params, a: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) attention outputs through ``wo`` -> (..., D)."""
    return _dot(a, params["wo"], 2, params["wo"].dim() == 4)


def _attn_block(cfg: ModelConfig, q_blk, k, v, offset: int, S: int, window: int):
    """Attention of one query block vs the full K/V. q_blk: (B, qs, Hkv, g, hd)."""
    qs = q_blk.shape[1]
    scores = torch.einsum("bsngk,btnk->bnsgt", q_blk, k).float()
    scores = scores / math.sqrt(cfg.hd)
    i = offset + torch.arange(qs, device=k.device)[:, None]
    j = torch.arange(S, device=k.device)[None, :]
    mask = j <= i
    if window and window > 0:
        mask &= j > i - window
    # -1e30, not -inf: the JAX package's fill, kept for equal softmaxes
    scores = scores.masked_fill(~mask[None, None, :, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(k.dtype)
    return torch.einsum("bnsgt,btnk->bsngk", probs, v)


def _checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass (the
    JAX package's ``jax.checkpoint``) while autograd records."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def attention(params, cfg: ModelConfig, x, positions, window: int = -1):
    """Training-mode causal (optionally sliding-window) GQA attention.

    x: (B, S, D). window: -1 -> cfg.sliding_window, 0 -> full causal.
    Queries run in blocks of ``attn_qchunk``, each under activation
    checkpointing, so only one block's (S x S/nb) scores live at a time
    (plain PyTorch, as the JAX package computes it outside any kernel).
    """
    B, S, _ = x.shape
    hd = cfg.hd
    group = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(params, cfg, x, positions)
    # (B, S, n_kv, group, hd): the grouped query layout of the JAX package
    q = q.reshape(B, S, cfg.n_kv_heads, group, hd)
    w = cfg.sliding_window if window == -1 else window

    qc = cfg.attn_qchunk
    if qc <= 0 or S <= qc:
        out = _attn_block(cfg, q, k, v, 0, S, w)
    else:
        assert S % qc == 0, (S, qc)
        outs = [
            _checkpointed(lambda qi, kk, vv, i=i: _attn_block(cfg, qi, kk, vv, i * qc, S, w),
                          q[:, i * qc:(i + 1) * qc], k, v)
            for i in range(S // qc)
        ]
        out = torch.cat(outs, dim=1)
    return attention_out(params, out.reshape(B, S, cfg.n_heads, hd))


def attention_decode(params, cfg: ModelConfig, x, cache, window: int = -1):
    """Single-token decode: x (B, 1, D); cache dict(k, v, index).

    cache["k"], cache["v"]: (B, C, n_kv, hd), C = full sequence or the
    sliding-window ring; cache["index"]: 0-dim int32, tokens already cached.
    With a ring (C < sequence) positions keep counting up but writes wrap.
    The new K/V are written into the cache in place (the JAX package
    re-emits it); the returned cache holds the same K/V tensors and
    ``index + 1``.
    """
    B = x.shape[0]
    hd = cfg.hd
    group = cfg.n_heads // cfg.n_kv_heads
    C = cache["k"].shape[1]
    idx = cache["index"]

    positions = default_positions(cfg, B, 1, offset=idx.reshape(1, 1).expand(B, 1))
    q, k, v = _qkv(params, cfg, x, positions)  # (B, 1, h, hd)

    slot = torch.remainder(idx, C).to(torch.int64)
    ck, cv = cache["k"], cache["v"]
    ck.index_copy_(1, slot.reshape(1), k.to(ck.dtype))
    cv.index_copy_(1, slot.reshape(1), v.to(cv.dtype))

    q = q.reshape(B, 1, cfg.n_kv_heads, group, hd)
    scores = torch.einsum("bsngk,btnk->bnsgt", q, ck).float() / math.sqrt(hd)

    # valid slots: those already written (ring-aware); ring order does not
    # matter to the softmax
    t = torch.arange(C, device=x.device)
    valid = t < torch.clamp(idx + 1, max=C)
    w = cfg.sliding_window if window == -1 else window
    if w and 0 < w < C:
        # a ring sized >= the window: all written slots are within it
        valid &= torch.remainder(slot - t, C) < w
    scores = scores.masked_fill(~valid[None, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bnsgt,btnk->bsngk", probs, cv).reshape(B, 1, cfg.n_heads, hd)
    y = attention_out(params, out)
    return y, {"k": ck, "v": cv, "index": idx + 1}


def attention_cache_init(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None):
    """KV cache for one layer. Sliding-window archs get a ring of the window."""
    C = max_seq
    if cfg.sliding_window and cfg.sliding_window < max_seq:
        C = cfg.sliding_window
    dtype = dtype or cfg.dtype
    return {
        "k": torch.zeros((batch, C, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, C, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------
def mlp_init(key, cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    k_g, k_u, k_d = rnd.split(key, 3)
    p = {
        "wu": dense_init(k_u, (cfg.d_model, d_ff), cfg.dtype),
        "wd": dense_init(k_d, (d_ff, cfg.d_model), cfg.dtype),
    }
    if cfg.gated_mlp:
        p["wg"] = dense_init(k_g, (cfg.d_model, d_ff), cfg.dtype)
    return p


def mlp(params, x):
    stacked = params["wu"].dim() == 3
    if "wg" in params:  # SwiGLU
        h = F.silu(_dot(x, params["wg"], 1, stacked))
        h = h * _dot(x, params["wu"], 1, stacked)
    else:  # plain GELU (starcoder2); jax.nn.gelu's default is the tanh form
        h = F.gelu(_dot(x, params["wu"], 1, stacked), approximate="tanh")
    return _dot(h, params["wd"], 1, stacked)


# ---------------------------------------------------------------------------
# Standard pre-norm transformer block (attention + MLP)
# ---------------------------------------------------------------------------
def block_init(key, cfg: ModelConfig):
    k_a, k_m = rnd.split(key, 2)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, cfg.dtype, key.device),
        "attn": attention_init(k_a, cfg),
        "mlp_norm": rmsnorm_init(cfg.d_model, cfg.dtype, key.device),
        "mlp": mlp_init(k_m, cfg),
    }


def block_apply(params, cfg: ModelConfig, x, positions, window: int = -1):
    a = attention(params["attn"], cfg, rmsnorm(params["attn_norm"], x, cfg.norm_eps), positions, window)
    x = x + a
    m = mlp(params["mlp"], rmsnorm(params["mlp_norm"], x, cfg.norm_eps))
    return x + m


def block_decode(params, cfg: ModelConfig, x, cache, window: int = -1):
    a, cache = attention_decode(
        params["attn"], cfg, rmsnorm(params["attn_norm"], x, cfg.norm_eps), cache, window
    )
    x = x + a
    x = x + mlp(params["mlp"], rmsnorm(params["mlp_norm"], x, cfg.norm_eps))
    return x, cache
