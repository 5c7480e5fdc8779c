"""Server-side FL optimizers (Reddi et al., *Adaptive Federated
Optimization*): the aggregated client delta is a pseudo-gradient.

Port of ``repro.fl.algorithms``. Every op is elementwise, so one call
updates every slot of a stacked CohortBank (the JAX package vmaps it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.utils import tree_add, tree_map, tree_scale, tree_zeros_like


@dataclasses.dataclass(frozen=True)
class ServerOpt:
    name: str
    init: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (params, state, delta)


def _fedavg(lr: float = 1.0) -> ServerOpt:
    def init(params):
        return {}

    def apply(params, state, delta):
        return tree_add(params, tree_scale(delta, lr)), state

    return ServerOpt("fedavg", init, apply)


def _adaptive(kind: str, lr: float = 1e-2, beta1=0.9, beta2=0.99, tau=1e-3) -> ServerOpt:
    def init(params):
        return {
            "m": tree_zeros_like(params),
            "v": tree_map(lambda x: torch.full_like(x, tau * tau), params),
        }

    def apply(params, state, delta):
        m = tree_map(lambda m, d: beta1 * m + (1 - beta1) * d, state["m"], delta)
        if kind == "yogi":
            v = tree_map(
                lambda v, d: v - (1 - beta2) * (d * d) * torch.sign(v - d * d),
                state["v"], delta,
            )
        elif kind == "adam":
            v = tree_map(lambda v, d: beta2 * v + (1 - beta2) * d * d, state["v"], delta)
        elif kind == "adagrad":
            v = tree_map(lambda v, d: v + d * d, state["v"], delta)
        else:
            raise ValueError(kind)
        new = tree_map(lambda p, m, v: p + lr * m / (torch.sqrt(v) + tau), params, m, v)
        return new, {"m": m, "v": v}

    return ServerOpt(f"fed{kind}", init, apply)


SERVER_OPTS: Dict[str, Callable[..., ServerOpt]] = {
    "fedavg": _fedavg,
    "fedyogi": lambda **kw: _adaptive("yogi", **kw),
    "fedadam": lambda **kw: _adaptive("adam", **kw),
    "fedadagrad": lambda **kw: _adaptive("adagrad", **kw),
}


def make_server_opt(name: str, **kw) -> ServerOpt:
    key = name.lower().replace("-", "").replace("_", "")
    if key in ("yogi", "fedyogi"):
        return SERVER_OPTS["fedyogi"](**kw)
    if key in ("adam", "fedadam"):
        return SERVER_OPTS["fedadam"](**kw)
    if key in ("adagrad", "fedadagrad"):
        return SERVER_OPTS["fedadagrad"](**kw)
    if key in ("avg", "fedavg", "qfedavg", "fedprox"):
        # fedprox/q-fedavg modify the client side; server update is FedAvg
        return SERVER_OPTS["fedavg"](**kw)
    raise ValueError(f"unknown FL algorithm {name}")


def apply_stacked(opt: ServerOpt, params, state, delta, update_mask: torch.Tensor):
    """Apply ``opt`` to every cohort slot of a CohortBank at once.

    params/state/delta leaves carry a leading slot axis (C, ...);
    update_mask is a (C,) bool vector. Slots where it is False keep their
    params and opt state bit-identical (``torch.where`` selects the old
    values, it does not recompute them).
    """
    new_p, new_s = opt.apply(params, state, delta)

    def sel(n, o):
        return torch.where(update_mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    new_state = {
        group: tree_map(sel, new_s[group], state[group]) for group in new_s
    }
    return tree_map(sel, new_p, params), new_state
