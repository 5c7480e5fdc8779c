"""Full-model assembly (port of ``repro.models.transformer``): every
family of the zoo (dense, MoE, VLM, audio, the SSM xLSTM and the hybrid
Mamba-2 + shared attention).

Layer parameters are stacked (leading axes = depth), as in the JAX
package. Each layer's weights are drawn from its own key of
``split(key, n_layers)`` (the JAX package vmaps the per-layer init over
those keys, which draws the same numbers) one layer at a time, so no draw
is ever larger than one layer's biggest leaf. ``model_init`` can write
straight into preallocated storage (``out=``: one slot of a cohort bank),
so a bank is filled in place and never built twice; its leaves are then
drawn a chunk at a time into that storage. With ``shards`` as well (a
tree of ``rnd.Shard``, ``Model.init_local``), ``out`` holds one card's
blocks and each leaf draws only that card's elements, from the same keys.

The training forward loops over the layers, each under activation
checkpointing (the JAX package's ``lax.scan`` of ``jax.checkpoint``):
whole layers under ``remat_policy="full"``, the attention, MLP and MoE
sub-blocks, whose outputs are then kept, under "outputs"; the cross-entropy head runs in token chunks of
``ce_chunk``, each checkpointed, so the (B, S, V) logits never exist at
once. ``params["backbone"]`` holds the block stacks that
``block_stacks(cfg)`` names, each with its layer axes: ``blocks`` (L,);
llama4's alternation ``dense_blocks`` and ``moe_blocks`` (L/2,), applied as
(dense, MoE) pairs; zamba2's ``mamba`` (n_super, attn_every) superblocks,
each followed by the one ``shared_attn`` block (unstacked, its weights
reused by every application), then ``mamba_tail`` (the leftover layers);
xlstm's ``mlstm`` (n_groups, g - 1) and ``slstm`` (n_groups,), a group
being g - 1 mLSTM layers then one sLSTM layer. A stack is a dict of
stacked leaves, or (as the training step passes it) nested lists of
per-layer dicts, so that autograd hands back each layer's gradient alone
instead of a full stacked tensor per layer.

The VLM prepends its projected image patch embeddings (early fusion) and
rotates with M-RoPE; the audio family embeds and predicts ``n_codebooks``
parallel token streams (tokens (B, nc, S), logits (B, S, nc, V)). The SSM
and hybrid blocks are ``models/ssm.py``; their decode caches carry the
recurrent states (and one KV cache per application of the shared block).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.models import moe, ssm
from repro_torch.models.common import (
    Draw,
    ModelConfig,
    _checkpointed,
    _dot,
    attention_cache_init,
    block_apply,
    block_decode,
    block_init,
    default_positions,
    deferred_draws,
    embed_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.utils import spmd
from repro_torch.utils.tree import tree_map

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (...) -> (..., D). With a stacked (R, V, D) table, tokens lead
    with R and each row looks up its own table. Audio: tokens (B, nc, S) and
    a (nc, V, D) table; the codebooks' embeddings are summed in order."""
    # a vocab-split table's lookup is a pending sum over the shards (its
    # all-reduce), a D-split one's is gathered: the residual stream starts
    # whole on every card of a data group
    x = _lookup(spmd.weight(params["embed"]), cfg, tokens)
    return spmd.keep_shards(x, range(x.dim() - 1))


def _lookup(emb, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # DTensor's own embedding of a vocab-split table masks the tokens with a
    # data-dependent check that fake tensors cannot run: ``spmd.vocab_lookup``
    if cfg.n_codebooks:
        x = None
        for c in range(cfg.n_codebooks):
            e = (spmd.vocab_lookup(emb[c], tokens[:, c]) if spmd.is_dtensor(emb)
                 else F.embedding(tokens[:, c], emb[c]))
            x = e if x is None else x + e
        return x
    if spmd.is_dtensor(emb) and emb.dim() == 2:
        return spmd.vocab_lookup(emb, tokens)
    if emb.dim() == 3:
        R = emb.shape[0]
        rows = torch.arange(R, device=tokens.device).reshape((R,) + (1,) * (tokens.dim() - 1))
        return emb[rows, tokens]
    return F.embedding(tokens, emb)


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., padded vocab); the tied head reads the embedding.
    Audio: (B, S, D) -> (B, S, nc, V), one head per codebook."""
    if cfg.n_codebooks:
        heads = params["heads"]
        if spmd.any_dtensor(x, heads):  # each head partitioned as a dot
            return torch.stack([spmd.replicate_partial(_dot(x, heads[c], 1, False))
                                for c in range(cfg.n_codebooks)], dim=2)
        return torch.einsum("bsd,cdv->bscv", x, heads)
    stacked = params["embed"].dim() == 3
    if cfg.tie_embeddings:
        head = params["embed"].transpose(-1, -2)
    else:
        head = params["head"]
    # a head split on D (a vocab no card count divides) leaves partial logits
    logits = spmd.replicate_partial(_dot(x, head, 1, stacked))
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
def _write(dst, src, shards=None):
    """Copy every leaf of ``src`` into ``dst`` (in place): a ``Draw`` is
    drawn into it, and with ``shards`` (a tree of ``rnd.Shard`` over each
    leaf's dims) only the card's block of each leaf is written."""
    for k, v in src.items():
        sh = None if shards is None else shards[k]
        if isinstance(v, dict):
            _write(dst[k], v, sh)
        elif isinstance(v, Draw):
            v.fill(dst[k], sh)
        else:
            dst[k].copy_(v if sh is None else v[sh.slices()])


def _stacked_init(key, n: int, init_fn: Callable, out: Optional[Params] = None, shards=None) -> Params:
    """``vmap(init_fn)(split(key, n))`` one layer at a time: layer i's
    leaves are drawn from the i-th key and written into ``out[...][i]``
    (allocated from layer 0's shapes when not given; ``shards`` as in
    ``_write``, over a layer's dims)."""
    keys = rnd.split(key, n)
    # on the meta device (shapes only) one layer gives every layer's shapes
    for i in range(1 if key.is_meta else n):
        layer = init_fn(keys[i])
        if out is None:
            out = tree_map(lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device), layer)
        _write(tree_map(lambda a: a[i], out), layer, shards)
    return out


def block_stacks(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The backbone's layer stacks and their layer axes: (L,) for a plain
    stack, (n_super, attn_every) and (n_groups, g - 1) for zamba2's and
    xlstm's nested ones, () for zamba2's one shared block."""
    f = cfg.family
    if f in ("dense", "vlm", "audio") or (f == "moe" and cfg.moe_interleave == 1):
        return {"blocks": (cfg.n_layers,)}
    if f == "moe":
        return {"dense_blocks": (cfg.n_layers // 2,), "moe_blocks": (cfg.n_layers // 2,)}
    if f == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        leftover = cfg.n_layers - n_super * cfg.attn_every
        stacks = {"mamba": (n_super, cfg.attn_every)}
        if leftover:
            stacks["mamba_tail"] = (leftover,)
        stacks["shared_attn"] = ()
        return stacks
    if f == "ssm":
        g = cfg.slstm_every
        return {"mlstm": (cfg.n_layers // g, g - 1), "slstm": (cfg.n_layers // g,)}
    raise ValueError(f"unknown family {f}")


def _is_moe(cfg: ModelConfig, stack: str) -> bool:
    """Whether the block stack ``stack`` holds MoE blocks."""
    return stack == "moe_blocks" or (stack == "blocks" and cfg.family == "moe")


_SSM_INIT = {"mamba": ssm.mamba2_init, "mamba_tail": ssm.mamba2_init, "mlstm": ssm.mlstm_init,
             "slstm": ssm.slstm_init}


def _layer_init(cfg: ModelConfig, stack: str) -> Callable:
    """The per-layer init of the block stack ``stack``."""
    if stack in _SSM_INIT:
        return _SSM_INIT[stack]
    return moe.moe_block_init if _is_moe(cfg, stack) else block_init


# the stacks' keys of split(key, 8), as the JAX package draws them (the rest
# draw from keys[0])
_STACK_KEY = {"moe_blocks": 1, "mamba_tail": 1, "slstm": 1, "shared_attn": 2}


def _body(shards, n_stack: int):
    """Per-layer shards of a stack's leaves (their ``n_stack`` layer axes
    whole: the specs never split a layer axis)."""
    def one(s):
        if s.offsets[:n_stack] != (0,) * n_stack:
            raise ValueError(f"a layer axis of {s} is split")
        return rnd.Shard(tuple(s.local_shape[n_stack:]), tuple(s.offsets[n_stack:]))
    return None if shards is None else tree_map(one, shards)


def backbone_init(key, cfg: ModelConfig, out: Optional[Params] = None, shards=None) -> Params:
    """A nested stack's layers are drawn flat, from ``split(key, n)`` over
    all its n layers, and viewed nested, as the JAX package reshapes them.
    ``out`` and ``shards`` as in ``model_init``."""
    keys = rnd.split(key, 8)
    out = out or {}
    p: Params = {}
    for name, dims in block_stacks(cfg).items():
        k = keys[_STACK_KEY.get(name, 0)]
        init = lambda k, f=_layer_init(cfg, name): f(k, cfg)
        sh = None if shards is None else shards[name]
        if not dims:  # zamba2's shared block: one copy
            p[name] = init(k)
            if name in out:
                _write(out[name], p[name], sh)
                p[name] = out[name]
            continue
        n = math.prod(dims)
        flat = (tree_map(lambda a: a.view((n,) + tuple(a.shape[len(dims):])), out[name])
                if name in out else None)
        flat = _stacked_init(k, n, init, flat, _body(sh, len(dims)))
        p[name] = out[name] if name in out else tree_map(
            lambda a: a.view(tuple(dims) + tuple(a.shape[1:])), flat)
    return p


def model_init(key, cfg: ModelConfig, out: Optional[Params] = None, shards=None) -> Params:
    """Params drawn on ``key``'s device. With ``out`` (a params tree of the
    right shapes, e.g. one slot of a bank), every leaf is drawn into it in
    place, a chunk at a time, and ``out`` is returned. With ``shards`` too
    (a params-shaped tree of ``rnd.Shard``), ``out`` holds those blocks of
    the leaves, and each is drawn alone: one card's shards of the init, bit
    for bit, without any whole leaf."""
    if shards is not None and out is None:
        raise ValueError("a sharded init draws into given storage: pass out")
    with deferred_draws() if out is not None else contextlib.nullcontext():
        return _model_init(key, cfg, out, shards)


def _model_init(key, cfg: ModelConfig, out, shards) -> Params:
    k_e, k_b, k_h = rnd.split(key, 3)
    dev = key.device
    p: Params = {
        "backbone": backbone_init(k_b, cfg, None if out is None else out["backbone"],
                                  None if shards is None else shards["backbone"]),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
    }
    if cfg.n_codebooks:
        p["embed"] = embed_init(k_e, (cfg.n_codebooks, cfg.vocab, cfg.d_model), cfg.dtype)
        # one key per codebook's head: a (nc, D, V) leaf
        p["heads"] = embed_init(rnd.split(k_h, cfg.n_codebooks), (cfg.d_model, cfg.vocab), cfg.dtype)
    else:
        p["embed"] = embed_init(k_e, (cfg.padded_vocab, cfg.d_model), cfg.dtype)
        if not cfg.tie_embeddings:
            p["head"] = embed_init(k_h, (cfg.d_model, cfg.padded_vocab), cfg.dtype)
    if cfg.family == "vlm":
        # projector of the (stubbed) vision frontend's patch embeddings
        p["vis_proj"] = embed_init(rnd.fold_in(k_h, 1), (cfg.d_model, cfg.d_model), cfg.dtype)
    if out is None:
        return p
    _write(out, {k: v for k, v in p.items() if k != "backbone"}, shards)
    return out


# ---------------------------------------------------------------------------
# Forward (training) pass
# ---------------------------------------------------------------------------
def layers(blocks, dims: Tuple[int, ...]):
    """The per-layer param dicts of a block stack with layer axes ``dims``:
    ``blocks`` as given when it is already a list (or unstacked, dims ()),
    else layer i's views ``a[i]`` of every leaf, as nested lists for a
    nested stack."""
    if isinstance(blocks, list) or not dims:
        return blocks
    return [layers(tree_map(lambda a, i=i: a[i], blocks), dims[1:]) for i in range(dims[0])]


def backbone_apply(params, cfg: ModelConfig, x, positions, window: int = -1):
    """x: (B, S, D) -> (B, S, D), aux dict. One layer (llama4: one dense /
    MoE pair) at a time, each under ``cfg.checkpoint()`` (remat "full": the
    layer checkpointed whole; "outputs": its attention, MLP and MoE
    sub-blocks each, ``common.saved_output``). The SSM layers (Mamba-2,
    mLSTM) are checkpointed alone under either policy, as the reference
    tags nothing inside them; the sLSTM layers under none: their
    activations are small, and a recompute would run their time loop
    (launch-bound) once more. The MoE layers' lb and z losses are summed and
    divided by n_layers (llama4: by the number of pairs); the other
    families' are zero."""
    stacks = block_stacks(cfg)
    per = {name: layers(params[name], dims) for name, dims in stacks.items()}
    ckpt = cfg.checkpoint()
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)
    zero = {"lb_loss": lb, "z_loss": zl}
    if cfg.family == "hybrid":
        def mamba(p, x):
            return ssm.mamba2_apply(p, cfg, x)

        for sup in per["mamba"]:
            for p in sup:
                x = _checkpointed(mamba, p, x)
            x = ckpt(lambda p, x: block_apply(p, cfg, x, positions, window), per["shared_attn"], x)
        for p in per.get("mamba_tail", []):
            x = _checkpointed(mamba, p, x)
        return x, zero
    if cfg.family == "ssm":
        for group, p_s in zip(per["mlstm"], per["slstm"]):
            for p in group:
                x = _checkpointed(lambda p, x: ssm.mlstm_apply(p, cfg, x), p, x)
            x = ssm.slstm_apply(p_s, cfg, x)
        return x, zero
    if cfg.family != "moe":
        for p in per["blocks"]:
            x = ckpt(lambda p, x: block_apply(p, cfg, x, positions, window), p, x)
        return x, zero

    def layer(p, x):
        if "moe_blocks" in stacks:
            x = block_apply(p[0], cfg, x, positions, window)
        x, a = moe.moe_block_apply(p[-1], cfg, x, positions, window)
        return x, a["lb_loss"], a["z_loss"]

    pairs = list(zip(*per.values()))
    for p in pairs:
        x, l_i, z_i = ckpt(layer, list(p), x)
        lb, zl = lb + l_i, zl + z_i
    return x, {"lb_loss": lb / len(pairs), "z_loss": zl / len(pairs)}


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], window: int = -1):
    """Embed -> backbone -> final norm. Returns (hidden (B, S, D), aux). A
    VLM batch with ``image_embeds`` (B, P, D) prepends their projections
    (early fusion) and returns the hidden states of the text positions."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = embed_tokens(params, cfg, tokens)
    vision = cfg.family == "vlm" and "image_embeds" in batch
    if vision:
        vis = batch["image_embeds"].to(x.dtype) @ params["vis_proj"]
        x = torch.cat([vis, x], dim=1)
    S = x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, B, S, device=x.device)
    x, aux = backbone_apply(params["backbone"], cfg, x, positions, window)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if vision:
        x = x[:, batch["image_embeds"].shape[1]:]  # logits over the text positions
    return x, aux


def _ce_block(params, cfg: ModelConfig, h_blk, tgt_blk, mask_blk):
    """CE summed over one token block. h_blk: (B, T, D); tgt (B, T) (audio:
    (B, T, nc), the CE averaged over the codebooks); mask (B, T)."""
    lg = lm_logits(params, cfg, h_blk).float()
    if spmd.is_dtensor(lg):
        lse, pick = spmd.logsumexp_and_pick(lg, tgt_blk)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        pick = torch.gather(lg, -1, tgt_blk[..., None])[..., 0]
    per_tok = lse - pick
    if cfg.n_codebooks:
        per_tok = torch.mean(per_tok, dim=-1)
    return torch.sum(per_tok * mask_blk)


def head_ce(params, cfg: ModelConfig, hidden, tokens):
    """Next-token cross-entropy in token chunks of ``ce_chunk`` (each under
    activation checkpointing), so the (B, S, V) logits are never all
    materialized. Targets < 0 are masked (audio: no target is); the sum is
    divided by ``max(mask.sum(), 1)``."""
    if cfg.n_codebooks:
        tgt = tokens[:, :, 1:].transpose(1, 2).long()  # (B, S-1, nc)
    else:
        tgt = tokens[:, 1:].long()
    h = hidden[:, :-1]
    Sm1 = h.shape[1]
    mask = torch.ones(tgt.shape[:2], device=tgt.device) if cfg.n_codebooks else (tgt >= 0).float()
    tgt = torch.clamp(tgt, min=0)

    T = cfg.ce_chunk
    if T <= 0 or Sm1 <= T:
        total = _ce_block(params, cfg, h, tgt, mask)
        return total / torch.clamp(mask.sum(), min=1.0)

    pad = (-Sm1) % T
    h = spmd.pad(h, (0, 0, 0, pad))
    tgt = spmd.pad(tgt, (0, 0) * (tgt.dim() - 2) + (0, pad))
    mask_p = spmd.pad(mask, (0, pad))
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
    """Next-token cross-entropy (+ the MoE aux terms, zero for the other
    families). Returns (loss, metrics)."""
    hidden, aux = forward_hidden(params, cfg, batch, window)
    ce = head_ce(params, cfg, hidden, batch["tokens"])
    loss = ce + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Decode (serving) pass: one new token against the cached state
# ---------------------------------------------------------------------------
def _stacked_cache(dims: Tuple[int, ...], one: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One layer's cache repeated over the layer axes ``dims``."""
    return {k: a.expand(tuple(dims) + tuple(a.shape)).clone() for k, a in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None):
    """Per-layer caches stacked like the block stacks, under each stack's
    name: k, v (L, B, C, Hkv, hd) and index (L,) for attention layers.
    zamba2: the Mamba-2 conv and SSM states of ``mamba`` (n_super,
    attn_every, ...) and ``mamba_tail``, and ``attn``, one KV cache per
    application of the shared block (n_super of them for one set of
    weights). xlstm: the mLSTM's C and n, the sLSTM's c, n, m and h."""
    stacks = block_stacks(cfg)
    if cfg.family == "hybrid":
        cache = {"mamba": _stacked_cache(stacks["mamba"], ssm.mamba2_cache_init(cfg, batch, dtype, device)),
                 "attn": _stacked_cache(stacks["mamba"][:1],
                                        attention_cache_init(cfg, batch, max_seq, dtype, device))}
        if "mamba_tail" in stacks:
            cache["mamba_tail"] = _stacked_cache(stacks["mamba_tail"],
                                                 ssm.mamba2_cache_init(cfg, batch, dtype, device))
        return cache
    if cfg.family == "ssm":
        return {"mlstm": _stacked_cache(stacks["mlstm"], ssm.mlstm_cache_init(cfg, batch, dtype, device)),
                "slstm": _stacked_cache(stacks["slstm"], ssm.slstm_state_init(cfg, batch, device))}
    one = attention_cache_init(cfg, batch, max_seq, dtype, device)
    return {name: _stacked_cache(dims, one) for name, dims in stacks.items()}


def _recurrent(decode, p, cfg: ModelConfig, x, cache, at):
    """One recurrent layer's decode against the states ``cache[...][at]``,
    which the new states overwrite in place."""
    x, new = decode(p, cfg, x, {k: a[at] for k, a in cache.items()})
    for k, a in new.items():
        cache[k][at].copy_(a)
    return x


def _attend(decode, p, cfg: ModelConfig, x, c, i, window, index):
    """An attention layer's decode against layer ``i`` of the stacked KV
    cache ``c`` (K/V written in place); its new index goes into ``index``."""
    x, ci = decode(p, cfg, x, {"k": c["k"][i], "v": c["v"][i], "index": c["index"][i]}, window)
    index.append(ci["index"])
    return x


def decode_step(params, cfg: ModelConfig, tokens, cache, window: int = -1):
    """tokens: (B, 1) (audio: (B, nc, 1)) -> (logits (B, 1, V) (audio:
    (B, 1, nc, V)), cache). The cache's K/V and recurrent states are
    written in place; the returned cache holds them and the new indices."""
    x = embed_tokens(params, cfg, tokens)
    bb = params["backbone"]
    stacks = block_stacks(cfg)
    per = {name: layers(bb[name], dims) for name, dims in stacks.items()}
    if cfg.family == "hybrid":
        index = []
        for s, sup in enumerate(per["mamba"]):
            for j, p in enumerate(sup):
                x = _recurrent(ssm.mamba2_decode, p, cfg, x, cache["mamba"], (s, j))
            x = _attend(block_decode, per["shared_attn"], cfg, x, cache["attn"], s, window, index)
        for i, p in enumerate(per.get("mamba_tail", [])):
            x = _recurrent(ssm.mamba2_decode, p, cfg, x, cache["mamba_tail"], i)
        new_cache = dict(cache, attn=dict(cache["attn"], index=torch.stack(index)))
    elif cfg.family == "ssm":
        for g, (group, p_s) in enumerate(zip(per["mlstm"], per["slstm"])):
            for j, p in enumerate(group):
                x = _recurrent(ssm.mlstm_decode, p, cfg, x, cache["mlstm"], (g, j))
            x = _recurrent(ssm.slstm_decode, p_s, cfg, x, cache["slstm"], g)
        new_cache = cache
    else:
        index = {name: [] for name in stacks}
        for i, ps in enumerate(zip(*per.values())):
            for name, p in zip(stacks, ps):  # llama4: the pair's dense layer, then its MoE layer
                decode = moe.moe_block_decode if _is_moe(cfg, name) else block_decode
                x = _attend(decode, p, cfg, x, cache[name], i, window, index[name])
        new_cache = {name: dict(cache[name], index=torch.stack(index[name])) for name in stacks}
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), new_cache
