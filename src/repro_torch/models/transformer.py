"""Full-model assembly: the dense family of ``repro.models.transformer``.

Layer parameters are stacked (leading axis = depth), as in the JAX
package. Each layer's weights are drawn from its own key of
``split(key, n_layers)`` (the JAX package vmaps the per-layer init over
those keys, which draws the same numbers) one layer at a time, so no draw
is ever larger than one layer's biggest leaf. ``model_init`` can write
straight into preallocated storage (``out=``: one slot of a cohort bank),
so a bank is filled in place and never built twice.

Other families (MoE, SSM, hybrid, VLM, audio) are a later port slice and
raise ``NotImplementedError``. The training forward and the ring-buffer
decode step are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import random as rnd
from repro_torch.utils.tree import map_nested
from repro_torch.models.common import (
    LATER,
    ModelConfig,
    _dot,
    block_init,
    embed_init,
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
    return emb[tokens]


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
            out = map_nested(lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device), layer)
        _write(map_nested(lambda a: a[i], out), layer)
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
