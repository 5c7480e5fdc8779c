"""Plain float32 reference of the benchmark's dense decoder configurations.

Pre-norm blocks: RMSNorm, grouped-query attention with rotary positions
(the halves of each head rotated, theta from the configuration), causal
softmax scaled by 1/sqrt(head_dim), a residual add; RMSNorm, a SwiGLU MLP,
a residual add; a final RMSNorm and the tied embedding as the head. Next
token cross-entropy is averaged over every target of the batch.

Weights are the benchmark's dotted names (``perfbench.lib.weights``); the
stacked block leaves (L, ...) are taken apart into one leaf per layer, so
autograd gives each layer's gradient alone. Written from the equations
with plain torch operations; it imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BLOCK = "backbone.blocks."


def precision(tf32: bool):
    """float32 matmuls in full float32 (TF32 off), or TF32 for the control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd), positions (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(cfg: dict, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One block on x (B, S, D)."""
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    h = rmsnorm(x, w["attn_norm.scale"], eps)
    q = rope(torch.einsum("bsd,dhk->bshk", h, w["attn.wq"]), pos, theta)
    k = rope(torch.einsum("bsd,dhk->bshk", h, w["attn.wk"]), pos, theta)
    v = torch.einsum("bsd,dhk->bshk", h, w["attn.wv"])
    group = q.shape[2] // k.shape[2]  # query head i reads kv head i // group
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhk,bthk->bhqt", q, k) / math.sqrt(q.shape[-1])
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    a = torch.einsum("bhqt,bthk->bqhk", p, v)
    x = x + torch.einsum("bqhk,hkd->bqd", a, w["attn.wo"])
    h = rmsnorm(x, w["mlp_norm.scale"], eps)
    return x + (F.silu(h @ w["mlp.wg"]) * (h @ w["mlp.wu"])) @ w["mlp.wd"]


def per_layer(weights: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """The stacked block leaves as one dict of (unstacked) views a layer."""
    names = [n for n in weights if n.startswith(BLOCK)]
    L = weights[names[0]].shape[0]
    return [{n[len(BLOCK):]: weights[n][i] for n in names} for i in range(L)]


def hidden(cfg: dict, layers: List[Dict[str, torch.Tensor]], embed: torch.Tensor,
           final_norm: torch.Tensor, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, D). ``remat`` recomputes
    each layer in the backward pass (memory only: the same arithmetic)."""
    x = embed[tokens.long()]
    for w in layers:
        if remat:
            keys = sorted(w)
            x = checkpoint(lambda x, *ws: layer(cfg, x, dict(zip(keys, ws))), x,
                           *[w[k] for k in keys], use_reentrant=False)
        else:
            x = layer(cfg, x, w)
    return rmsnorm(x, final_norm, float(cfg["rms_norm_eps"]))


def logits(cfg: dict, weights: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """(B, S, V) float32 logits of every position, no gradient."""
    with torch.no_grad():
        h = hidden(cfg, per_layer(weights), weights["embed"], weights["final_norm.scale"], tokens)
        return h @ weights["embed"].T


def loss_and_grads(cfg: dict, weights: Dict[str, torch.Tensor], tokens: torch.Tensor):
    """(loss, views, grads): the mean next-token cross-entropy, and the
    gradient of every per-layer view of the weights (the views share the
    weights' storage, so an update in place on a view updates them)."""
    layers = [{k: t.detach().requires_grad_(True) for k, t in w.items()} for w in per_layer(weights)]
    embed = weights["embed"].detach().requires_grad_(True)
    final = weights["final_norm.scale"].detach().requires_grad_(True)
    keys = sorted(layers[0])
    flat = [t for w in layers for t in (w[k] for k in keys)] + [embed, final]
    with torch.enable_grad():
        h = hidden(cfg, layers, embed, final, tokens, remat=True)
        lg = h[:, :-1] @ embed.T
        loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), tokens[:, 1:].reshape(-1).long())
        del lg, h
        grads = list(torch.autograd.grad(loss, flat))
    return loss.detach(), [t.detach() for t in flat], grads
