"""Model handle: binds a ModelConfig to its init (port of ``repro.models.zoo``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.utils.tree import map_nested


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, key, out=None, device=None) -> Dict[str, Any]:
        """Params drawn from ``key`` on ``device`` (the card unless the
        caller passes ``device="cpu"``); with ``out``, written into it in
        place."""
        return transformer.model_init(key.to(resolve_device(device)), self.cfg, out)

    def init_shapes(self) -> Dict[str, Any]:
        """The params tree on the ``meta`` device: shapes and dtypes, no
        storage and no arithmetic."""
        return transformer.model_init(rnd.key(0, device="meta"), self.cfg)

    def param_count(self) -> int:
        return sum(math.prod(a.shape) for a in _leaves(self.init_shapes()))

    def init_bank(self, key, n_slots: int, device=None) -> Dict[str, Any]:
        """A cohort bank of ``n_slots`` models on ``device`` (as ``init``),
        every leaf (n_slots, ...): slot i is ``init(fold_in(key, i))``, drawn
        straight into its slot (no model is built twice)."""
        dev = resolve_device(device)
        key = key.to(dev)
        bank = map_nested(
            lambda a: torch.empty((n_slots,) + tuple(a.shape), dtype=a.dtype, device=dev),
            self.init_shapes(),
        )
        for i in range(n_slots):
            self.init(rnd.fold_in(key, i), out=map_nested(lambda a: a[i], bank), device=dev)
        return bank


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
