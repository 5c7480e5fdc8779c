"""Model handle: binds a ModelConfig to its init, loss and decode callables
(port of ``repro.models.zoo``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.utils.tree import leaves, leaves_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, key, out=None, device=None) -> Dict[str, Any]:
        """Params drawn from ``key`` on ``device`` (the card unless the
        caller passes ``device="cpu"``); with ``out``, written into it in
        place."""
        return transformer.model_init(key.to(resolve_device(device)), self.cfg, out)

    def init_local(self, key, shards, device=None) -> Dict[str, Any]:
        """One card's blocks of ``init(key)``: ``shards`` is a params-shaped
        tree of ``rnd.Shard`` (``launch.local.param_shards``), and each leaf
        draws only its block's elements, from the keys ``init`` draws the
        whole leaf from, on ``device`` (the card unless the caller passes
        ``device="cpu"``). Bit-equal to slicing ``init(key)``; no whole leaf
        is ever made."""
        dev = resolve_device(device)
        out = tree_map(lambda a, s: torch.empty(tuple(s.local_shape), dtype=a.dtype, device=dev),
                       self.init_shapes(), shards)
        return transformer.model_init(key.to(dev), self.cfg, out, shards)

    def init_shapes(self, key=None) -> Dict[str, Any]:
        """The params tree on the ``meta`` device: shapes and dtypes, no
        storage and no arithmetic (``key``, where given, goes to the meta
        device too: the shapes do not depend on it)."""
        key = rnd.key(0, device="meta") if key is None else key.to("meta")
        return transformer.model_init(key, self.cfg)

    def forward(self, params, batch, window: int = -1):
        return transformer.forward(params, self.cfg, batch, window)

    def loss(self, params, batch, window: int = -1):
        return transformer.loss_fn(params, self.cfg, batch, window)

    def init_cache(self, batch: int, max_seq: int, dtype=None, device=None):
        """Decode caches on ``device`` (the card unless the caller passes
        ``device="cpu"``)."""
        return transformer.init_cache(self.cfg, batch, max_seq, dtype, resolve_device(device))

    def decode_step(self, params, tokens, cache, window: int = -1):
        return transformer.decode_step(params, self.cfg, tokens, cache, window)

    def param_count(self) -> int:
        return sum(math.prod(a.shape) for a in leaves(self.init_shapes()))

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k of n_experts count). As
        the JAX package counts them: a leaf whose key path names ``'wg'``,
        ``'wu'`` or ``'wd'`` and ``moe`` (llama4's shared expert included)
        counts ``n * top_k // n_experts``."""
        if not self.cfg.is_moe_arch:
            return self.param_count()
        total = 0
        for path, leaf in leaves_with_path(self.init_shapes()):
            n = math.prod(leaf.shape)
            if any(w in path for w in ("'wg'", "'wu'", "'wd'")) and "moe" in path:
                n = n * self.cfg.top_k // self.cfg.n_experts
            total += n
        return total

    def init_bank(self, key, n_slots: int, device=None) -> Dict[str, Any]:
        """A cohort bank of ``n_slots`` models on ``device`` (as ``init``),
        every leaf (n_slots, ...): slot i is ``init(fold_in(key, i))``, drawn
        straight into its slot (no model is built twice)."""
        dev = resolve_device(device)
        key = key.to(dev)
        bank = tree_map(
            lambda a: torch.empty((n_slots,) + tuple(a.shape), dtype=a.dtype, device=dev),
            self.init_shapes(),
        )
        for i in range(n_slots):
            self.init(rnd.fold_in(key, i), out=tree_map(lambda a: a[i], bank), device=dev)
        return bank


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
