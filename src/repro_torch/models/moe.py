"""Mixture-of-Experts layer: top-k token-choice routing with capacity
(port of ``repro.models.moe``).

Tokens are routed in groups of ``moe_group``; each expert takes at most
``cap`` tokens of a group, the later ones dropped first. Dispatch and
combine are the JAX package's one-hot products: each (expert, slot) holds
one token or none, so the dispatch copies values exactly, and every sum has
a fixed order on the card (no atomics), bit-equal run to run.

The layer runs in four stages, each a function of its own so that a caller
can time them apart: ``route`` (router product, softmax, top-k), ``dispatch``
(buffer positions, keep mask, tokens into expert slots), ``experts`` (the
SwiGLU of every expert over its slots, one batched matmul per weight) and
``combine`` (slots back to tokens, weighted). ``moe_apply`` chains them.

Stacked rows: params with a leading row axis (R, ...) and an input
(R, B, S, D) run every row with its own weights, as the JAX package's
``vmap``; the aux terms are then (R,). Unstacked calls are the R = 1 case.

Covers qwen3-moe-235b-a22b (128 experts top-8) and llama4-maverick-400b-a17b
(128 experts top-1 + a shared expert, alternating dense / MoE layers).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.models.common import (
    ModelConfig,
    _dot,
    attention,
    attention_decode,
    attention_init,
    dense_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.utils.tree import tree_map


def moe_init(key, cfg: ModelConfig):
    k_r, k_g, k_u, k_d, k_s = rnd.split(key, 5)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(k_r, (D, E), torch.float32),  # the router stays float32
        "wg": dense_init(k_g, (E, D, Fd), cfg.dtype),
        "wu": dense_init(k_u, (E, D, Fd), cfg.dtype),
        "wd": dense_init(k_d, (E, Fd, D), cfg.dtype),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_init(k_s, cfg)
    return p


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    cap = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    # round to a multiple of 8, min 8
    cap = max(8, (cap + 7) // 8 * 8)
    return min(cap, tokens_per_group)


def route(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (G, T, D) grouped tokens, or (R, G, T, D) with a stacked router
    (R, D, E) -> (weights (..., G, T, k), ids (..., G, T, k), aux).

    Top-k keeps ``jax.lax.top_k``'s order: by probability, ties to the
    lower expert index (a stable descending sort; ``torch.topk`` does not
    promise it)."""
    stacked = params["router"].dim() == 3
    # in the router's dtype: float32 (a float64 reference run: float64)
    logits = _dot(x.to(params["router"].dtype), params["router"], 1, stacked)  # (..., G, T, E)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[..., :cfg.top_k], order[..., :cfg.top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch) over the top-1 choices + router z-loss
    me = torch.mean(probs, dim=(-3, -2))  # (..., E)
    ce = torch.mean(F.one_hot(ids[..., 0], cfg.n_experts).float(), dim=(-3, -2))
    lb_loss = cfg.n_experts * torch.sum(me * ce, dim=-1)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)), dim=(-2, -1))
    return weights, ids, {"lb_loss": lb_loss, "z_loss": z_loss}


def dispatch(cfg: ModelConfig, xg: torch.Tensor, weights: torch.Tensor, ids: torch.Tensor):
    """Tokens into expert slots. xg (R, G, Tg, D), weights/ids (R, G, Tg, k)
    -> (expert_in (R, E, G, cap, D), combine (R, G, Tg, E, cap) in x's
    dtype, keep (R, G, Tg, k)).

    A choice's slot is the count of earlier choices of its expert in the
    group, counted token-major over (Tg·k); choices at slot >= cap, or of
    weight 0, are dropped."""
    R, G, Tg, _ = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = _capacity(Tg, cfg)
    onehot = F.one_hot(ids, E)  # (R, G, Tg, k, E)
    flat = onehot.reshape(R, G, Tg * k, E)
    pos = torch.cumsum(flat, dim=2) - 1
    pos = (pos * flat).sum(-1).reshape(R, G, Tg, k)
    keep = (pos < cap) & (weights > 0)

    oh_e = onehot.to(xg.dtype) * keep[..., None].to(xg.dtype)
    # one_hot of a slot >= cap is all zeros (jax.nn.one_hot's rule)
    oh_c = (pos[..., None] == torch.arange(cap, device=xg.device)).to(xg.dtype)  # (R,G,Tg,k,cap)
    disp = torch.einsum("rgske,rgskc->rgsec", oh_e, oh_c)  # (R, G, Tg, E, cap)
    expert_in = torch.einsum("rgsec,rgsd->regcd", disp, xg)
    combine = torch.einsum("rgske,rgskc->rgsec", oh_e * weights.to(xg.dtype)[..., None], oh_c)
    return expert_in, combine, keep


def experts(params, expert_in: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of every expert over its slots: expert_in (R, E, G, cap, D),
    params (R, E, D, F) / (R, E, F, D) -> (R, E, G, cap, D). Expert-major,
    so each product is one batched matmul over (R·E)."""
    h = F.silu(torch.einsum("regcd,redf->regcf", expert_in, params["wg"]))
    h = h * torch.einsum("regcd,redf->regcf", expert_in, params["wu"])
    return torch.einsum("regcf,refd->regcd", h, params["wd"])


def combine(comb: torch.Tensor, expert_out: torch.Tensor) -> torch.Tensor:
    """Slots back to tokens: (R, G, Tg, E, cap) x (R, E, G, cap, D) -> (R, G, Tg, D)."""
    return torch.einsum("rgsec,regcd->rgsd", comb, expert_out)


def group(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(R, B, S, D) -> (R, B·S/Tg, Tg, D) routing groups, Tg = min(moe_group, S)."""
    R, B, S, D = x.shape
    Tg = min(cfg.moe_group, S)
    if S % Tg:
        raise ValueError(f"sequence {S} is not a multiple of the routing group {Tg}")
    return x.reshape(R, B * (S // Tg), Tg, D)


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, D) -> (B, S, D), aux (lb_loss, z_loss, frac_dropped); with
    stacked params (R, ...), x (R, B, S, D) and every aux term (R,)."""
    if params["router"].dim() == 2:
        y, aux = moe_apply(tree_map(lambda a: a[None], params), cfg, x[None])
        return y[0], {k: v[0] for k, v in aux.items()}
    xg = group(cfg, x)
    weights, ids, aux = route(params, cfg, xg)
    expert_in, comb, keep = dispatch(cfg, xg, weights, ids)
    y = combine(comb, experts(params, expert_in))
    if cfg.shared_expert:
        y = y + mlp(params["shared"], xg)
    aux = dict(aux, frac_dropped=1.0 - torch.mean(keep.float(), dim=(1, 2, 3)))
    return y.reshape(x.shape), aux


def moe_block_init(key, cfg: ModelConfig):
    k_a, k_m = rnd.split(key, 2)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, cfg.dtype, key.device),
        "attn": attention_init(k_a, cfg),
        "moe_norm": rmsnorm_init(cfg.d_model, cfg.dtype, key.device),
        "moe": moe_init(k_m, cfg),
    }


def moe_block_apply(params, cfg: ModelConfig, x, positions, window: int = -1):
    a = attention(params["attn"], cfg, rmsnorm(params["attn_norm"], x, cfg.norm_eps), positions, window)
    x = x + a
    y, aux = moe_apply(params["moe"], cfg, rmsnorm(params["moe_norm"], x, cfg.norm_eps))
    return x + y, aux


def moe_block_decode(params, cfg: ModelConfig, x, cache, window: int = -1):
    """One token (S = 1): a group of one token, capacity 1, so every one of
    its k choices is kept."""
    a, cache = attention_decode(
        params["attn"], cfg, rmsnorm(params["attn_norm"], x, cfg.norm_eps), cache, window
    )
    x = x + a
    y, _ = moe_apply(params["moe"], cfg, rmsnorm(params["moe_norm"], x, cfg.norm_eps))
    return x + y, cache

