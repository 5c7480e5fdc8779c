"""Full-model assembly: the dense family of ``repro.models.transformer``.

Layer parameters are stacked (leading axis = depth), as in the JAX
package. Each layer's weights are drawn from its own key of
``split(key, n_layers)`` (the JAX package vmaps the per-layer init over
those keys, which draws the same numbers) one layer at a time, so no draw
is ever larger than one layer's biggest leaf. ``model_init`` can write
straight into preallocated storage (``out=``: one slot of a cohort bank),
so a bank is filled in place and never built twice.

The training forward loops over the layers, each under activation
checkpointing (the JAX package's ``lax.scan`` of ``jax.checkpoint`` with
``remat_policy="full"``); the cross-entropy head runs in token chunks of
``ce_chunk``, each checkpointed, so the (B, S, V) logits never exist at
once. ``params["backbone"]["blocks"]`` is a dict of stacked (L, ...)
leaves, or a list of L per-layer dicts: the training step passes the
latter, per-layer leaf tensors, so that autograd hands back each layer's
gradient alone instead of a full (L, ...) tensor per layer.

Other families (MoE, SSM, hybrid, VLM, audio) are a later port slice and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.utils.tree import tree_map
from repro_torch.models.common import (
    LATER,
    ModelConfig,
    _checkpointed,
    _dot,
    attention_cache_init,
    block_apply,
    block_decode,
    block_init,
    default_positions,
    embed_init,
    rmsnorm,
    rmsnorm_init,
)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (...) -> (..., D). With a stacked (R, V, D) table, tokens lead
    with R and each row looks up its own table."""
    if cfg.n_codebooks:
        raise NotImplementedError(f"codebook embeddings (audio): {LATER}")
    emb = params["embed"]
    if emb.dim() == 3:
        R = emb.shape[0]
        rows = torch.arange(R, device=tokens.device).reshape((R,) + (1,) * (tokens.dim() - 1))
        return emb[rows, tokens]
    return F.embedding(tokens, emb)


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., padded vocab); the tied head reads the embedding."""
    if cfg.n_codebooks:
        raise NotImplementedError(f"codebook heads (audio): {LATER}")
    stacked = params["embed"].dim() == 3
    if cfg.tie_embeddings:
        head = params["embed"].transpose(-1, -2)
    else:
        head = params["head"]
    logits = _dot(x, head, 1, stacked)
    if cfg.padded_vocab > cfg.vocab:
        # mask the pad slots
        pad_bias = torch.where(
            torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab, 0.0, -1e30
        ).to(logits.dtype)
        logits = logits + pad_bias
    return logits


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _write(dst, src):
    """Copy every leaf of ``src`` into ``dst`` (in place)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        else:
            dst[k].copy_(v)


def _stacked_init(key, n: int, init_fn: Callable, out: Optional[Params] = None) -> Params:
    """``vmap(init_fn)(split(key, n))`` one layer at a time: layer i's
    leaves are drawn from the i-th key and written into ``out[...][i]``
    (allocated from layer 0's shapes when not given)."""
    keys = rnd.split(key, n)
    # on the meta device (shapes only) one layer gives every layer's shapes
    for i in range(1 if key.is_meta else n):
        layer = init_fn(keys[i])
        if out is None:
            out = tree_map(lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device), layer)
        _write(tree_map(lambda a: a[i], out), layer)
    return out


def backbone_init(key, cfg: ModelConfig, out: Optional[Params] = None) -> Params:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} backbone: {LATER}")
    keys = rnd.split(key, 8)
    blocks = _stacked_init(
        keys[0], cfg.n_layers, lambda k: block_init(k, cfg), None if out is None else out["blocks"]
    )
    return {"blocks": blocks}


def model_init(key, cfg: ModelConfig, out: Optional[Params] = None) -> Params:
    """Params drawn on ``key``'s device. With ``out`` (a params tree of the
    right shapes, e.g. one slot of a bank), every leaf is written into it in
    place and ``out`` is returned."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} model: {LATER}")
    k_e, k_b, k_h = rnd.split(key, 3)
    dev = key.device
    p: Params = {
        "backbone": backbone_init(k_b, cfg, None if out is None else out["backbone"]),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
        "embed": embed_init(k_e, (cfg.padded_vocab, cfg.d_model), cfg.dtype),
    }
    if not cfg.tie_embeddings:
        p["head"] = embed_init(k_h, (cfg.d_model, cfg.padded_vocab), cfg.dtype)
    if out is None:
        return p
    _write(out, {k: v for k, v in p.items() if k != "backbone"})
    return out


# ---------------------------------------------------------------------------
# Forward (training) pass
# ---------------------------------------------------------------------------
def _dense_only(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} family: {LATER}")


def layers(blocks, n: int):
    """The per-layer param dicts of a block stack: ``blocks`` as given when
    it is already a list, else layer i's views ``a[i]`` of every leaf."""
    if isinstance(blocks, list):
        return blocks
    return [tree_map(lambda a, i=i: a[i], blocks) for i in range(n)]


def backbone_apply(params, cfg: ModelConfig, x, positions, window: int = -1):
    """x: (B, S, D) -> (B, S, D), aux dict. One layer at a time, each under
    activation checkpointing (remat "full")."""
    _dense_only(cfg)
    aux = {
        "lb_loss": torch.zeros((), dtype=torch.float32, device=x.device),
        "z_loss": torch.zeros((), dtype=torch.float32, device=x.device),
    }
    for p in layers(params["blocks"], cfg.n_layers):
        x = _checkpointed(lambda p, x: block_apply(p, cfg, x, positions, window), p, x)
    return x, aux


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], window: int = -1):
    """Embed -> backbone -> final norm. Returns (hidden (B, S, D), aux)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, B, S, device=x.device)
    x, aux = backbone_apply(params["backbone"], cfg, x, positions, window)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def _ce_block(params, cfg: ModelConfig, h_blk, tgt_blk, mask_blk):
    """CE summed over one token block. h_blk: (B, T, D); tgt, mask (B, T)."""
    lg = lm_logits(params, cfg, h_blk).float()
    lse = torch.logsumexp(lg, dim=-1)
    pick = torch.gather(lg, -1, tgt_blk[..., None])[..., 0]
    return torch.sum((lse - pick) * mask_blk)


def head_ce(params, cfg: ModelConfig, hidden, tokens):
    """Next-token cross-entropy in token chunks of ``ce_chunk`` (each under
    activation checkpointing), so the (B, S, V) logits are never all
    materialized. Targets < 0 are masked; the sum is divided by
    ``max(mask.sum(), 1)``."""
    if cfg.n_codebooks:
        raise NotImplementedError(f"codebook heads (audio): {LATER}")
    tgt = tokens[:, 1:].long()
    h = hidden[:, :-1]
    Sm1 = h.shape[1]
    mask = (tgt >= 0).float()
    tgt = torch.clamp(tgt, min=0)

    T = cfg.ce_chunk
    if T <= 0 or Sm1 <= T:
        total = _ce_block(params, cfg, h, tgt, mask)
        return total / torch.clamp(mask.sum(), min=1.0)

    pad = (-Sm1) % T
    h = F.pad(h, (0, 0, 0, pad))
    tgt = F.pad(tgt, (0, pad))
    mask_p = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(h.shape[1] // T):
        sl = slice(i * T, (i + 1) * T)
        total = total + _checkpointed(
            lambda hh, tt, mm: _ce_block(params, cfg, hh, tt, mm), h[:, sl], tgt[:, sl], mask_p[:, sl]
        )
    return total / torch.clamp(mask.sum(), min=1.0)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], window: int = -1):
    """Returns (logits, aux). batch: tokens (+ positions)."""
    x, aux = forward_hidden(params, cfg, batch, window)
    return lm_logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch, window: int = -1):
    """Next-token cross-entropy (+ the MoE aux terms, zero here). Returns
    (loss, metrics)."""
    hidden, aux = forward_hidden(params, cfg, batch, window)
    ce = head_ce(params, cfg, hidden, batch["tokens"])
    loss = ce + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Decode (serving) pass: one new token against the cached state
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None):
    """Stacked per-layer caches: k, v (L, B, C, Hkv, hd), index (L,)."""
    _dense_only(cfg)
    one = attention_cache_init(cfg, batch, max_seq, dtype, device)
    return {"blocks": {k: torch.zeros((cfg.n_layers,) + tuple(a.shape), dtype=a.dtype, device=a.device)
                       for k, a in one.items()}}


def decode_step(params, cfg: ModelConfig, tokens, cache, window: int = -1):
    """tokens: (B, 1) -> (logits (B, 1, V), cache). The cache's K/V are
    written in place; the returned cache holds them and the new indices."""
    _dense_only(cfg)
    x = embed_tokens(params, cfg, tokens)
    c = cache["blocks"]
    new_index = []
    for i, p in enumerate(layers(params["backbone"]["blocks"], cfg.n_layers)):
        x, ci = block_decode(p, cfg, x, {"k": c["k"][i], "v": c["v"][i], "index": c["index"][i]}, window)
        new_index.append(ci["index"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_logits(params, cfg, x)
    return logits, {"blocks": {"k": c["k"], "v": c["v"], "index": torch.stack(new_index)}}
