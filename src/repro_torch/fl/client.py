"""Client-side local training (the Execution stage of Fig. 1).

Port of ``repro.fl.client.local_train``. JAX vmaps the single-client SGD
loop over the round's rows; here every row's params are stacked on a
leading axis (R, ...) and trained together: the forward pass is one
batched matmul per layer, and autograd of the SUMMED row losses gives each
row exactly its own gradient (rows share no parameters). ``lax.scan`` over
local steps is a Python loop. Returns each row's model delta — the
quantity clients upload and Auxo clusters on. FedProx and local DP (clip
+ Gaussian noise from per-row threefry keys) are kept.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.utils import tree_dot, tree_sub


def local_train(
    loss_fn: Callable,
    params: Dict[str, torch.Tensor],  # (R, ...) stacked per-row params
    xs: torch.Tensor,  # (R, steps, batch, ...) per-row local data
    ys: torch.Tensor,  # (R, steps, batch)
    noise_keys: Optional[torch.Tensor] = None,  # (R, 2) threefry keys (DP noise)
    *,
    lr: float = 0.05,
    prox_mu: float = 0.0,
    dp_clip: float = 0.0,
    dp_sigma: float = 0.0,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (delta dict (R, ...), mean local loss per row (R,))."""
    names = sorted(params)
    init = {k: v.detach() for k, v in params.items()}
    p = {k: v.detach().clone() for k, v in params.items()}
    losses = []
    for s in range(xs.shape[1]):
        with torch.enable_grad():
            for v in p.values():
                v.requires_grad_(True)
            rows = loss_fn(p, (xs[:, s], ys[:, s]))  # (R,)
            if prox_mu > 0.0:
                d = tree_sub(p, init)
                rows = rows + 0.5 * prox_mu * tree_dot(d, d, batch_dims=1)
            grads = torch.autograd.grad(rows.sum(), [p[k] for k in names])
        p = {k: (p[k] - lr * g).detach() for k, g in zip(names, grads)}
        losses.append(rows.detach())
    delta = tree_sub(p, init)

    if dp_clip > 0.0:
        # local DP: clip each row's update, add calibrated Gaussian noise
        nrm = torch.sqrt(tree_dot(delta, delta, batch_dims=1))
        scale = torch.clamp(dp_clip / torch.clamp(nrm, min=1e-9), max=1.0)
        delta = {k: v * scale.reshape((-1,) + (1,) * (v.dim() - 1)) for k, v in delta.items()}
        if dp_sigma > 0.0:
            if noise_keys is None:
                raise ValueError("dp_sigma > 0 needs per-row noise keys")
            keys = rnd.split(noise_keys, len(names))  # (R, n_leaves, 2)
            for j, k in enumerate(names):
                noise = rnd.xla_normal(keys[:, j], delta[k].shape[1:])
                delta[k] = delta[k] + dp_sigma * dp_clip * noise
    return delta, torch.stack(losses, 1).mean(1)
