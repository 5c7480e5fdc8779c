"""FL task: a model + loss + eval packaged for the round engine.

Port of ``repro.fl.task.MLPTask`` (the classifier every paper benchmark
runs). Params are a dict ``{"w0": (in, h), ..., "b0": (h,), ...}``; every
method also takes stacked params with a leading row axis (R, ...) and then
runs all rows as one batched matmul (``torch.bmm``), the port's form of
JAX's ``vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import random as rnd
from repro_torch.models.common import dense_init


@dataclasses.dataclass(frozen=True)
class MLPTask:
    dim: int = 32
    n_classes: int = 10
    hidden: int = 64
    depth: int = 2

    @property
    def head_paths(self):
        n = self.depth  # last layer index
        return (f"'w{n}'", f"'b{n}'")

    def init(self, key) -> Dict[str, torch.Tensor]:
        dims = [self.dim] + [self.hidden] * self.depth + [self.n_classes]
        keys = rnd.split(key, len(dims) - 1)
        out = {
            f"w{i}": dense_init(keys[i], (dims[i], dims[i + 1]))
            for i in range(len(dims) - 1)
        }
        for i in range(len(dims) - 1):
            out[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=torch.float32, device=key.device)
        return out

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (B, dim) with unbatched params, or (R, B, dim) with stacked
        (R, ...) params."""
        stacked = params["w0"].dim() == 3
        h = x
        n = self.depth + 1
        for i in range(n):
            w, b = params[f"w{i}"], params[f"b{i}"]
            h = (torch.bmm(h, w) + b[:, None, :]) if stacked else (h @ w + b)
            if i < n - 1:
                h = torch.relu(h)
        return h

    def loss(self, params, batch) -> torch.Tensor:
        """Mean cross-entropy: a scalar, or (R,) per row for stacked params."""
        x, y = batch
        lg = self.logits(params, x)
        return (torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, y.long()[..., None])[..., 0]).mean(-1)

    def correct_fraction(self, params, x, y) -> torch.Tensor:
        pred = torch.argmax(self.logits(params, x), dim=-1)
        return (pred == y.long()).float().mean(-1)

    def accuracy(self, params, x, y) -> float:
        dev = params["w0"].device
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        return float(self.correct_fraction(params, x, y))
