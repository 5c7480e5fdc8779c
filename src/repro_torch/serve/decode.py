"""Incremental per-cohort decode over the paged KV cache (port of
``repro.serve.decode``).

The serving plane's fast path for transformer cohort models: all live
cohorts' decode lanes advance one token per fleet step — gather each
cohort's params row from the (snapshot) stacked bank, run one decode step
for every row at once (the row axis written out; the matmuls over each
row's own weights are ``torch.bmm``), greedy-pick the next token.
Attention against the paged cache runs through
``kernels.ops.decode_attention`` (the CUDA split-KV flash-decode kernel on
the card, backend ``"kernel"``) with ``kernels.ref.decode_attention`` as
the selectable plain oracle (``"ref"``): backends must produce identical
greedy token streams.

Rows advance separately: each row has its own position (its RoPE offset
and its cache write position), so ``length`` is a (rows·lanes,) tensor and
the cache write is a per-row scatter. The cache is updated in place, one
position per layer and step; the JAX package re-emits it every step.

Memory: ``decode`` gathers the live rows' params once per call, layer-major
for the block stack, so each layer's rows are one contiguous (R, ...) slab
for ``torch.bmm``. At granite-3-2b's full width, float32, that is 10.13 GB
per row beside the bank itself (see ``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import (
    LATER,
    _qkv,
    attention_out,
    default_positions,
    mlp,
    rmsnorm,
)
from repro_torch.models.transformer import embed_tokens, lm_logits
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.utils.tree import tree_map

ATTEND = {
    "kernel": kops.decode_attention,
    "ref": kref.decode_attention,
}


def make_decode_step(cfg, attend: Callable) -> Callable:
    """One decode step for every cohort row at once.

    params: the gathered rows — block-stack leaves layer-major (L, R, ...),
    the rest (R, ...); tokens (R, lanes) int64; kc/vc (R, lanes, L, S, Hkv,
    hd), written in place at each row's position; index (R,) int64, each
    row's current position. Returns logits (R, lanes, V).
    """
    if cfg.family != "dense":
        # the JAX package's decoder asserts the dense family too
        raise NotImplementedError(f"paged decode serves the dense family only, not {cfg.family}")
    if cfg.sliding_window:
        raise NotImplementedError("paged decode is full-attention only (no sliding window)")

    def step(params, tokens, kc, vc, index):
        R, N = tokens.shape
        S = kc.shape[3]
        rows = torch.arange(R, device=tokens.device)
        x = embed_tokens(params, cfg, tokens[..., None])  # (R, N, 1, D)
        starts = index.repeat_interleave(N)  # (R·N,) each lane's row position
        positions = default_positions(cfg, R * N, 1, offset=starts[:, None]).reshape(R, N, 1)
        length = (starts + 1).to(torch.int32)
        blocks = params["backbone"]["blocks"]
        for layer in range(cfg.n_layers):
            p = tree_map(lambda a: a[layer], blocks)  # this layer's (R, ...) rows
            xa = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
            q, k, v = _qkv(p["attn"], cfg, xa, positions)  # (R, N, 1, H|Hkv, hd)
            kl, vl = kc[:, :, layer], vc[:, :, layer]  # (R, N, S, Hkv, hd) views
            # in place: this step's K/V land at each row's own position
            kl[rows, :, index] = k[:, :, 0].to(kl.dtype)
            vl[rows, :, index] = v[:, :, 0].to(vl.dtype)
            a = attend(
                q[:, :, 0].reshape(R * N, cfg.n_heads, cfg.hd),
                kl.reshape(R * N, S, cfg.n_kv_heads, cfg.hd),
                vl.reshape(R * N, S, cfg.n_kv_heads, cfg.hd),
                length,
            )  # (R·N, H, hd)
            x = x + attention_out(p["attn"], a.reshape(R, N, 1, cfg.n_heads, cfg.hd))
            x = x + mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params, cfg, x)[:, :, 0]

    return step


class CohortDecoder:
    """Fleet decoder: every live cohort × lane advances in one step.

    ``params_fn`` yields the stacked bank params to read (the serving
    plane's round-boundary snapshot), ``slots_fn`` the live cohort slots;
    ``sync()`` reconciles the paged cache against them with the bank's
    slot-scatter discipline (pages freed on partition/merge).
    """

    def __init__(
        self,
        model,
        params_fn: Callable,
        slots_fn: Callable,
        lanes: int = 4,
        page_size: int = 128,
        backend="kernel",
        device=None,
    ):
        self.model = model
        self.cfg = model.cfg
        self.params_fn = params_fn
        self.slots_fn = slots_fn
        self.lanes = int(lanes)
        self.backend = backend
        self.device = resolve_device(device)
        self.cache = PagedKVCache(
            n_layers=self.cfg.n_layers,
            lanes=self.lanes,
            n_kv_heads=self.cfg.n_kv_heads,
            head_dim=self.cfg.hd,
            page_size=page_size,
            dtype=torch.float32,
            device=self.device,
        )
        # a callable stands in for the attention (a checking harness that
        # runs the kernel and the plain version side by side)
        self._step = make_decode_step(self.cfg, backend if callable(backend) else ATTEND[backend])
        self.decode_dispatches = 0  # fleet steps run
        self.tokens: Optional[np.ndarray] = None  # (rows, lanes) last token

    @classmethod
    def from_engine(cls, engine, **kw) -> "CohortDecoder":
        model = engine.task.model  # a transformer task's model
        pipe = engine.pipeline

        def slots_fn():
            return [pipe.bank.slot_of[leaf] for leaf in engine.coordinator.tree.leaves()]

        kw.setdefault("device", getattr(engine, "device", None))
        return cls(model, lambda: pipe.serve_params, slots_fn, **kw)

    # ------------------------------------------------------------ plumbing
    @property
    def kv_nbytes(self) -> int:
        return self.cache.nbytes

    def sync(self):
        """Reconcile cache rows with the live cohort set (call after any
        round that may have partitioned)."""
        live = self.slots_fn()
        if self.cache.slots != [int(s) for s in live]:
            self.tokens = None  # fresh rows restart their lanes
        self.cache.sync(live)

    def _seed_tokens(self) -> np.ndarray:
        # deterministic per (slot, lane) seed token
        slots = np.asarray(self.cache.slots, np.int64)
        lane = np.arange(self.lanes, dtype=np.int64)[None, :]
        return ((slots[:, None] * self.lanes + lane) % self.cfg.vocab).astype(np.int32)

    def _gather(self, slots) -> dict:
        """The rows' params: block-stack leaves (L, R, ...), the rest (R, ...)."""
        bank = self.params_fn()
        blocks = tree_map(
            lambda a: torch.stack([a[s] for s in slots], dim=1), bank["backbone"]["blocks"]
        )
        idx = torch.as_tensor(slots, device=bank["embed"].device)
        rest = {k: tree_map(lambda a: a[idx], v) for k, v in bank.items() if k != "backbone"}
        return {"backbone": {"blocks": blocks}, **rest}

    # -------------------------------------------------------------- decode
    @torch.no_grad()
    def decode(self, n_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy-decode ``n_steps`` tokens on every live cohort lane.

        Returns (tokens (live_rows, lanes, n_steps) int32,
                 last-step logits (live_rows, lanes, V) float32).
        One fleet step per position for the WHOLE fleet; the tokens stay on
        the device until the call ends.
        """
        self.sync()
        live = self.cache.slots
        if not live:
            raise RuntimeError("no live cohorts to decode")
        self.cache.ensure(n_steps + 1)
        r_pad = self.cache.rows
        # pad rows re-use row 0's slot params; their lanes are discarded
        slots_p = live + [live[0]] * (r_pad - len(live))
        if self.tokens is None:
            self.tokens = self._seed_tokens()
        tok = np.zeros((r_pad, self.lanes), np.int64)
        tok[: len(live)] = self.tokens
        tok = torch.from_numpy(tok).to(self.device)
        params = self._gather(slots_p)
        index = torch.from_numpy(self.cache.index.astype(np.int64)).to(self.device)
        out = []
        logits = None
        for _ in range(int(n_steps)):
            logits = self._step(params, tok, self.cache.k, self.cache.v, index)
            self.decode_dispatches += 1
            tok = torch.argmax(logits, dim=-1)
            index = index + 1
            out.append(tok)
        self.cache.index = index.cpu().numpy().astype(np.int32)
        toks = torch.stack(out, dim=-1).cpu().numpy().astype(np.int32)  # (R, lanes, n_steps)
        self.tokens = toks[: len(live), :, -1]
        return toks[: len(live)], logits[: len(live)].float().cpu().numpy()
