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

import contextlib
import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random as rnd
from repro_torch.utils import spmd


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
    # remat policy of the layer stack (``checkpoint``, ``saved_output``):
    #   "full"    recompute each layer whole in the backward pass
    #   "outputs" keep the attention/MLP/MoE outputs, recompute inside them
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

    def checkpoint(self):
        """How ``backbone_apply`` runs one layer, ``ckpt(fn, *args)`` (the
        reference's ``jax.checkpoint`` under ``remat_policy``): "full"
        checkpoints the layer whole; "outputs" runs it as it stands, each of
        its tagged sub-blocks (``saved_output``) under a checkpoint of its
        own."""
        if self.remat_policy == "full":
            return _checkpointed
        if self.remat_policy == "outputs":
            return _call
        raise ValueError(f"unknown remat_policy {self.remat_policy!r} (full | outputs)")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Initializers (draws on the key's device)
# ---------------------------------------------------------------------------
_DEFER = [False]  # under ``deferred_draws``: the initializers return ``Draw``s


@contextlib.contextmanager
def deferred_draws():
    """Within it ``dense_init`` and ``embed_init`` draw nothing: they return
    a ``Draw``, which ``transformer.model_init`` fills into a leaf or a
    card's block of one (``Model.init_local``)."""
    prev, _DEFER[0] = _DEFER[0], True
    try:
        yield
    finally:
        _DEFER[0] = prev


@dataclasses.dataclass(frozen=True)
class Draw:
    """A random leaf not yet drawn: ``rnd.<kind>`` of ``shape`` per key of
    ``key`` (..., 2), times ``scale``, as ``dtype``: a (*key.shape[:-1],
    *shape) leaf."""

    key: torch.Tensor
    shape: Tuple[int, ...]
    dtype: Any
    kind: str  # "truncated_normal" | "normal"
    scale: float

    def fill(self, out: torch.Tensor, shard: Optional[rnd.Shard] = None) -> torch.Tensor:
        """Draw the leaf, or its block ``shard`` (over the leaf's dims), into
        ``out``: the block's own elements only, a chunk at a time."""
        key, nk = self.key.to(out.device), self.key.dim() - 1
        if shard is not None and nk:  # leading dims pick keys
            key = key[shard.slices()[:nk]]
            shard = rnd.Shard(tuple(shard.local_shape[nk:]), tuple(shard.offsets[nk:]))
        kw = dict(scale=self.scale, dtype=self.dtype, shard=shard, out=out)
        if self.kind == "normal":
            return rnd.normal(key, self.shape, **kw)
        return rnd.truncated_normal(key, -2.0, 2.0, self.shape, **kw)


def dense_init(key, shape, dtype=torch.float32, scale: Optional[float] = None):
    """Truncated-normal fan-in init (matches common LLM init schemes),
    drawn a chunk at a time (``rnd.CHUNK``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if _DEFER[0]:
        return Draw(key, tuple(shape), dtype, "truncated_normal", std)
    return rnd.truncated_normal(key, -2.0, 2.0, shape, scale=std, dtype=dtype)


def embed_init(key, shape, dtype):
    """Normal init at 0.02 (a batch of keys draws a leaf per key)."""
    if _DEFER[0]:
        return Draw(key, tuple(shape), dtype, "normal", 0.02)
    return rnd.normal(key, shape, scale=0.02, dtype=dtype)


# ---------------------------------------------------------------------------
# Stacked-row helpers
# ---------------------------------------------------------------------------
def _dot(x: torch.Tensor, w: torch.Tensor, k: int, stacked: bool) -> torch.Tensor:
    """Contract the last ``k`` axes of x with the first ``k`` axes of w (after
    w's row axis when ``stacked``: then x leads with the same rows and every
    row multiplies its own weights in one ``torch.bmm``)."""
    w = spmd.weight(w)
    if spmd.any_dtensor(x, w):
        return spmd.dot(x, w, k, 1 if stacked else 0, lambda a, b: _dot(a, b, k, stacked))
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
    # (built on the host: a repeat count held in a tensor would make the
    # output's length data-dependent, which fake tensors cannot give)
    sec_ids = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)], device=x.device)
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
    """(..., H, hd) attention outputs through ``wo`` -> (..., D). Split
    heads leave a pending sum, all-reduced here (the row-parallel product's
    all-reduce)."""
    return spmd.replicate_partial(_dot(a, params["wo"], 2, params["wo"].dim() == 4))


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


def _call(fn, *args):
    return fn(*args)


def saved_output(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, a sub-block whose result the reference tags for its
    "outputs" policy (``attn_out``, ``mlp_out``, ``moe_out``; it also names
    ``ssm_out``, which no code tags). Under ``remat_policy="outputs"`` it
    runs under a checkpoint of its own and its layer under none: the result
    is kept from the forward pass, the backward pass recomputes only inside
    the sub-block and stops before its output projection (the checkpoint's
    early stop), so the projection and the all-reduce of a DTensor's
    pending sum run once. The next sub-block's input (``x + result``) is
    what stays alive: one activation a tagged output that a later
    sub-block of the layer reads. Under "full" a plain call, inside the
    layer's checkpoint."""
    if cfg.remat_policy == "outputs":
        return _checkpointed(fn, *args)
    return fn(*args)


def attention(params, cfg: ModelConfig, x, positions, window: int = -1):
    """Training-mode causal (optionally sliding-window) GQA attention.

    x: (B, S, D). window: -1 -> cfg.sliding_window, 0 -> full causal.
    Queries run in blocks of ``attn_qchunk``, each under activation
    checkpointing, so only one block's (S x S/nb) scores live at a time
    (plain PyTorch, as the JAX package computes it outside any kernel).
    """
    q, k, v = _qkv(params, cfg, x, positions)
    w = cfg.sliding_window if window == -1 else window
    if spmd.is_dtensor(q):
        # each card attends with its own heads (and batch rows), on its shards
        q, k, v, pl = spmd.align_heads(q, k, v)
        out = spmd.local(lambda q, k, v: _attn_heads(cfg, q, k, v, w), (q, k, v), pl, q.device_mesh)
    else:
        out = _attn_heads(cfg, q, k, v, w)
    return attention_out(params, out)


def _attn_heads(cfg: ModelConfig, q, k, v, w: int):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd) -> (B, S, H, hd): the query
    blocks of causal GQA attention."""
    B, S, H, hd = q.shape
    n_kv = k.shape[2]
    # (B, S, n_kv, group, hd): the grouped query layout of the JAX package
    q = q.reshape(B, S, n_kv, H // n_kv, hd)
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
    return out.reshape(B, S, H, hd)


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
    if spmd.is_dtensor(ck):
        return _attention_decode_spmd(params, cfg, x, q, k, v, cache, slot, window)
    ck.index_copy_(1, slot.reshape(1), k.to(ck.dtype))
    cv.index_copy_(1, slot.reshape(1), v.to(cv.dtype))

    q = q.reshape(B, 1, cfg.n_kv_heads, group, hd)
    scores = torch.einsum("bsngk,btnk->bnsgt", q, ck).float() / math.sqrt(hd)

    valid = _decode_mask(cfg, idx, slot, C, window, x.device)
    scores = scores.masked_fill(~valid[None, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bnsgt,btnk->bsngk", probs, cv).reshape(B, 1, cfg.n_heads, hd)
    y = attention_out(params, out)
    return y, {"k": ck, "v": cv, "index": idx + 1}


def _decode_mask(cfg: ModelConfig, idx, slot, C: int, window: int, device, start: int = 0,
                 n: Optional[int] = None):
    """The valid slots of a (ring) KV cache of C slots: those already
    written; ring order does not matter to the softmax. ``start`` and ``n``
    pick the slots [start, start + n) of the C (a card's shard of a cache
    split on its sequence), each judged by its global position."""
    t = start + torch.arange(C if n is None else n, device=device)
    valid = t < torch.clamp(idx + 1, max=C)
    w = cfg.sliding_window if window == -1 else window
    if w and 0 < w < C:
        # a ring sized >= the window: all written slots are within it
        valid &= torch.remainder(slot - t, C) < w
    return valid


def _attention_decode_spmd(params, cfg: ModelConfig, x, q, k, v, cache, slot, window: int):
    """``attention_decode`` on a DTensor KV cache, each card on its shard of
    it, as GSPMD partitions the JAX package's decode:

    - a split of the batch or the kv heads stays local;
    - a split of hd leaves partial scores, all-reduced (far smaller than
      the cache);
    - a split of the sequence (the ring of a batch-1 decode, or
      ``cache_spec(seq_shard=True)``) gives each card its own slots: the new
      K/V land only in the shard that holds slot ``idx % C`` (a masked
      write, no host sync), each card masks its scores by their global
      positions, the softmax's max and sum are all-reduced (MAX, then SUM)
      across the cards of the split, and the cards' pending sums of
      probs · V are all-reduced."""
    ck, cv, idx = cache["k"], cache["v"], cache["index"]
    mesh = ck.device_mesh
    C, hd = ck.shape[1], cfg.hd
    kinds = {i: p.dim for i, p in enumerate(ck.placements) if p.is_shard() and mesh.size(i) > 1}
    # the token's q, k and v placed like the cache, whole along the sequence
    tok_pl = [spmd._replicate() if kinds.get(i) == 1 else p for i, p in enumerate(ck.placements)]
    start, n = spmd.shard_offset(ck, 1), ck.to_local().shape[1]  # this card's slots

    def write(cl, nl, sl):
        at = sl - start
        mine = (at >= 0) & (at < n)
        at = torch.where(mine, at, torch.zeros_like(at)).reshape(1)
        return cl.index_copy_(1, at, torch.where(mine, nl, cl.index_select(1, at)))

    for c, new in ((ck, k), (cv, v)):
        new = spmd.redistribute(spmd.replicate_partial(new.to(c.dtype)), tok_pl)
        spmd.local(write, (c, new, slot), c.placements, mesh)
    q = spmd.redistribute(spmd.replicate_partial(q), tok_pl)
    # scores (b, n, 1, g, t): batch, kv heads and slots split like the cache;
    # a split hd leaves them partial
    score_pl = [spmd._shard({0: 0, 1: 4, 2: 1}[kinds[i]]) if kinds.get(i) in (0, 1, 2)
                else (spmd._partial() if kinds.get(i) == 3 else spmd._replicate()) for i in range(mesh.ndim)]

    def scores_of(ql, kl):
        b, _, h, d = ql.shape
        m = kl.shape[2]
        return torch.einsum("bsngk,btnk->bnsgt", ql.reshape(b, 1, m, h // m, d), kl).float()

    scores = spmd.replicate_partial(spmd.local(scores_of, (q, ck), score_pl, mesh))
    # the softmax's max and sum: pending over a split of the slots
    pl = list(scores.placements)
    max_pl = [spmd._partial("max") if kinds.get(i) == 1 else p for i, p in enumerate(pl)]
    sum_pl = [spmd._partial() if kinds.get(i) == 1 else p for i, p in enumerate(pl)]

    def masked_max(s, i, sl):
        ok = _decode_mask(cfg, i, sl, C, window, s.device, start, n)
        s = (s / math.sqrt(hd)).masked_fill(~ok[None, None, None, None, :], -1e30)
        return s, s.amax(-1, keepdim=True)

    def exp_sum(s, m):
        e = torch.exp(s - m)
        return e, e.sum(-1, keepdim=True)

    scores, top = spmd.local(masked_max, (scores, idx, slot), [pl, max_pl], mesh)
    e, total = spmd.local(exp_sum, (scores, spmd.replicate_partial(top)), [pl, sum_pl], mesh)
    total = spmd.replicate_partial(total)
    out_pl = [spmd._shard({0: 0, 2: 2, 3: 3}[kinds[i]]) if kinds.get(i) in (0, 2, 3)
              else (spmd._partial() if kinds.get(i) == 1 else spmd._replicate()) for i in range(mesh.ndim)]

    def values_of(el, tl, vl):
        o = torch.einsum("bnsgt,btnk->bsngk", (el / tl).to(x.dtype), vl)
        return o.reshape(o.shape[0], 1, -1, o.shape[-1])

    out = spmd.replicate_partial(spmd.local(values_of, (e, total, cv), out_pl, mesh))  # (B, 1, H, hd)
    # heads, not hd, split for wo (an all-to-all of one token's outputs)
    out = spmd.redistribute(out, [spmd._shard(2) if p.is_shard() and p.dim == 3 else p for p in out.placements])
    return attention_out(params, out), {"k": ck, "v": cv, "index": idx + 1}


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
    return spmd.replicate_partial(_dot(h, params["wd"], 1, stacked))


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
    a = saved_output(cfg, lambda p, x: attention(
        p["attn"], cfg, rmsnorm(p["attn_norm"], x, cfg.norm_eps), positions, window), params, x)
    x = x + a
    m = saved_output(cfg, lambda p, x: mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps)),
                     params, x)
    return x + m


def block_decode(params, cfg: ModelConfig, x, cache, window: int = -1):
    a, cache = attention_decode(
        params["attn"], cfg, rmsnorm(params["attn_norm"], x, cfg.norm_eps), cache, window
    )
    x = x + a
    x = x + mlp(params["mlp"], rmsnorm(params["mlp_norm"], x, cfg.norm_eps))
    return x, cache
