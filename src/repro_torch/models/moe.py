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
    saved_output,
)
from repro_torch.utils import spmd
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


def _route_local(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor, reduce=torch.mean):
    """``route`` on one card's groups: (weights, ids, and the aux terms'
    ``reduce`` (mean, or sum for a card's share) over groups and tokens)."""
    # in the router's dtype: float32 (a float64 reference run: float64)
    logits = _dot(x.to(router.dtype), router, 1, router.dim() == 3)  # (..., G, T, E)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[..., :cfg.top_k], order[..., :cfg.top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch) over the top-1 choices + router z-loss
    me = reduce(probs, dim=(-3, -2))  # (..., E)
    ce = reduce(F.one_hot(ids[..., 0], cfg.n_experts).float(), dim=(-3, -2))
    z = reduce(torch.square(torch.logsumexp(logits, dim=-1)), dim=(-2, -1))
    return weights, ids, me, ce, z


def route(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (G, T, D) grouped tokens, or (R, G, T, D) with a stacked router
    (R, D, E) -> (weights (..., G, T, k), ids (..., G, T, k), aux).

    Top-k keeps ``jax.lax.top_k``'s order: by probability, ties to the
    lower expert index (a stable descending sort; ``torch.topk`` does not
    promise it). On DTensor groups each card routes its own groups with the
    whole (small) router; the aux terms' means over all groups come from
    sums all-reduced over the group split."""
    router = params["router"]
    if spmd.is_dtensor(x):
        mesh, gdim = x.device_mesh, x.dim() - 3
        x = spmd.keep_shards(x, (0, gdim))
        router = spmd.redistribute(spmd.weight(router), [spmd._replicate()] * mesh.ndim)
        split = {i: p.dim for i, p in enumerate(x.placements) if p.is_shard()}
        rows = list(x.placements)
        sums = [spmd._partial() if split.get(i) == gdim else (spmd._shard(0) if split.get(i) == 0
                                                              else spmd._replicate())
                for i in range(mesh.ndim)]
        weights, ids, *terms = spmd.local(lambda xl, rl: _route_local(cfg, xl, rl, torch.sum), (x, router),
                                          [rows, rows, sums, sums, sums], mesh)
        n = x.shape[-3] * x.shape[-2]
        me, ce, z = (spmd.replicate_partial(t) / n for t in terms)
    else:
        weights, ids, me, ce, z = _route_local(cfg, x, router)
    lb_loss = cfg.n_experts * torch.sum(me * ce, dim=-1)
    return weights, ids, {"lb_loss": lb_loss, "z_loss": z}


def dispatch(cfg: ModelConfig, xg: torch.Tensor, weights: torch.Tensor, ids: torch.Tensor,
             experts_of: slice = slice(None)):
    """Tokens into expert slots. xg (R, G, Tg, D), weights/ids (R, G, Tg, k)
    -> (expert_in (R, E, G, cap, D), combine (R, G, Tg, E, cap) in x's
    dtype, keep (R, G, Tg, k)); ``experts_of`` keeps those experts' slots
    only (a card's experts, E their count).

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

    oh_e = onehot[..., experts_of].to(xg.dtype) * keep[..., None].to(xg.dtype)
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
    wg, wu, wd = (spmd.weight(params[k]) for k in ("wg", "wu", "wd"))
    h = F.silu(torch.einsum("regcd,redf->regcf", expert_in, wg))
    h = h * torch.einsum("regcd,redf->regcf", expert_in, wu)
    return torch.einsum("regcf,refd->regcd", h, wd)


def combine(comb: torch.Tensor, expert_out: torch.Tensor) -> torch.Tensor:
    """Slots back to tokens: (R, G, Tg, E, cap) x (R, E, G, cap, D) -> (R, G, Tg, D)."""
    return torch.einsum("rgsec,regcd->rgsd", comb, expert_out)


def group(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(R, B, S, D) -> (R, B·S/Tg, Tg, D) routing groups, Tg = min(moe_group, S)."""
    x = spmd.keep_shards(x, (0, 1))  # routing runs on each card's rows, all of D
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
    if spmd.is_dtensor(xg):
        y, keep = _moe_spmd(params, cfg, xg, weights, ids)
    else:
        expert_in, comb, keep = dispatch(cfg, xg, weights, ids)
        y = combine(comb, experts(params, expert_in))
    if cfg.shared_expert:
        y = y + mlp(params["shared"], xg)
    aux = dict(aux, frac_dropped=1.0 - torch.mean(keep.float(), dim=(1, 2, 3)))
    return y.reshape(x.shape), aux


def _moe_spmd(params, cfg: ModelConfig, xg, weights, ids):
    """Dispatch, experts and combine on DTensors, each card on its own
    experts: it slots its groups' tokens (replicated over ``model``) into
    its experts only, runs them and combines their outputs, a pending sum
    over the expert split that is all-reduced (the program GSPMD gives
    expert-sharded weights and tokens replicated over the expert axis; in
    the backward the tokens' gradient is that sum's all-reduce, never a
    gather of the slot buffers). Expert weights split on another dim over a
    mesh dim are gathered there first. Returns (y, keep)."""
    mesh = xg.device_mesh
    w = {k: spmd.weight(params[k]) for k in ("wg", "wu", "wd")}
    edims = [i for i, p in enumerate(w["wg"].placements) if p == spmd._shard(1) and mesh.size(i) > 1]
    w = {k: spmd.redistribute(v, [spmd._shard(1) if i in edims else spmd._replicate()
                                  for i in range(mesh.ndim)]) for k, v in w.items()}
    rows = [spmd._replicate() if i in edims else p for i, p in enumerate(xg.placements)]
    xg, weights, ids = (spmd.redistribute(spmd.replicate_partial(t), rows) for t in (xg, weights, ids))
    e0, n_local = spmd.shard_offset(w["wg"], 1), w["wg"].to_local().shape[1]

    def fn(x, wt, i, wg, wu, wd):
        expert_in, comb, keep = dispatch(cfg, x, wt, i, slice(e0, e0 + n_local))
        return combine(comb, experts({"wg": wg, "wu": wu, "wd": wd}, expert_in)), keep

    out = [spmd._partial() if i in edims else p for i, p in enumerate(rows)]
    y, keep = spmd.local(fn, (xg, weights, ids, w["wg"], w["wu"], w["wd"]), [out, rows], mesh)
    return spmd.replicate_partial(y), keep


def moe_block_init(key, cfg: ModelConfig):
    k_a, k_m = rnd.split(key, 2)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, cfg.dtype, key.device),
        "attn": attention_init(k_a, cfg),
        "moe_norm": rmsnorm_init(cfg.d_model, cfg.dtype, key.device),
        "moe": moe_init(k_m, cfg),
    }


def moe_block_apply(params, cfg: ModelConfig, x, positions, window: int = -1):
    a = saved_output(cfg, lambda p, x: attention(
        p["attn"], cfg, rmsnorm(p["attn_norm"], x, cfg.norm_eps), positions, window), params, x)
    x = x + a
    y, aux = saved_output(cfg, lambda p, x: moe_apply(
        p["moe"], cfg, rmsnorm(p["moe_norm"], x, cfg.norm_eps)), params, x)
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

