"""Step functions of LM training and serving (port of ``repro.launch.steps``).

Two training modes, as in the JAX package:

- ``federated`` (``make_train_step``): the paper-faithful FL round. Each
  client runs local SGD on the model loss with global-norm clipping; each
  client's delta is sketched (last-block JL projection); Auxo's online
  clustering assigns and refreshes prototypes and computes rewards; the
  reward-weighted aggregate feeds the server optimizer (FedYoGi).
- ``centralized`` (``make_central_train_step``): a data-parallel step whose
  "clients" are batch groups; each client's sketch comes from the LM-head
  gradient with respect to the final hidden states.

Serving: ``make_prefill_step`` (last-position logits of a full forward) and
``make_serve_step`` (one token against the KV cache, ring-buffered for
sliding-window configs).

The port runs on one device, eagerly:

- Clients run in a Python loop (the port's form of the JAX ``vmap``). All
  C working copies live in one (C, ...) buffer per leaf; client c trains
  its row in place and the row becomes its delta in place (``p -= params``),
  so a round holds the C deltas, one set of gradients and the carried
  state: no per-client copy besides.
- Gradients are taken per layer: the step hands the model a list of
  per-layer leaf tensors (views of the working copy), so autograd returns
  each layer's gradient alone, and each SGD step's gradients are freed
  before the next one.
- The carried params and optimizer state are updated in place (what
  ``jit_train_step``'s donation gives the JAX package: one live copy).
- The clustering sums, its counts and the reward-weighted aggregation run
  through ``kernels.ops.segment_aggregate`` (the CUDA kernel on the card,
  the plain version on the CPU); the aggregation goes leaf by leaf, each
  leaf one (1, C, n_leaf) call, and the server optimizer applies each leaf
  as soon as its aggregate is ready.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List

import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.core.sketch import GradientSketcher
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer
from repro_torch.models.zoo import Model
from repro_torch.utils import spmd, trace
from repro_torch.utils.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# Auxo clustering state (per cohort, carried across rounds)
# ---------------------------------------------------------------------------
def clustering_init(k: int, d_sketch: int, device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "centroids": torch.zeros((k, d_sketch), dtype=torch.float32, device=dev),
        "counts": torch.zeros((k,), dtype=torch.float32, device=dev),
        "initialized": torch.zeros((), dtype=torch.float32, device=dev),
    }


def clustering_update(state, sketches: torch.Tensor, ema: float = 0.3):
    """Algorithm-1 round: center, normalize, assign, EMA refresh, instant
    rewards. sketches: (C, d). The cluster sums and counts are segment sums
    (``kernels.ops.segment_aggregate``); ``xn @ cents.T`` is a plain dot."""
    if spmd.is_dtensor(sketches):  # (C, d) is small: every card clusters all of it
        return spmd.replicated(lambda st, sk: clustering_update(st, sk, ema), state, sketches)
    x = sketches.float()
    C = x.shape[0]
    mu = torch.mean(x, dim=0, keepdim=True)
    xc = x - mu
    xn = xc / (torch.linalg.vector_norm(xc, dim=1, keepdim=True) + 1e-8)
    k = state["centroids"].shape[0]

    # bootstrap: the first round seeds with the two most anti-correlated
    # rows (the JAX package's stand-in for k-means++ inside its jit)
    sims_all = xn @ xn.T
    seed0 = torch.argmax(torch.sum(sims_all, dim=1))
    # a tensor index, not a Python one: no host read, and it runs on fake
    # tensors (the dry run's FakeTensorMode)
    seed1 = torch.argmin(torch.index_select(sims_all, 0, seed0[None])[0])
    boot = xn[torch.stack([seed0, seed1] + [(seed0 + i) % C for i in range(2, k)])]
    cents = torch.where(state["initialized"] > 0, state["centroids"], boot)

    sims = xn @ cents.T  # (C, K)
    assign = torch.argmax(sims, dim=1)  # ties: the first index, as jnp.argmax
    sums = kops.segment_aggregate(xn[None], assign[None], k)[0]
    counts = kops.segment_aggregate(
        torch.ones((1, C, 1), dtype=torch.float32, device=x.device), assign[None], k
    )[0, :, 0]
    batch_cent = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), cents)
    new_cents = (1 - ema) * cents + ema * batch_cent
    new_cents = new_cents / (torch.linalg.vector_norm(new_cents, dim=1, keepdim=True) + 1e-8)

    # instant rewards (paper §4.3): ΔR = 1 − D/(avg(D)+std(D)), population std
    d = torch.linalg.vector_norm(x - mu, dim=1)
    thr = torch.mean(d) + torch.std(d, correction=0)
    rewards = 1.0 - d / torch.clamp(thr, min=1e-9)

    picked = torch.gather(sims, 1, assign[:, None])[:, 0]
    new_state = {
        "centroids": new_cents,
        "counts": state["counts"] + counts,
        "initialized": torch.ones((), dtype=torch.float32, device=x.device),
    }
    metrics = {
        "assign": assign,
        "rewards": rewards,
        "dispersion": 1.0 - torch.mean(picked),
        "cluster_counts": counts,
    }
    return new_state, metrics


# ---------------------------------------------------------------------------
# Server optimizer (FedYoGi), in place over param trees
# ---------------------------------------------------------------------------
def yogi_init(params):
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(lambda x: torch.full_like(x, 1e-6, dtype=torch.float32), params),
    }


@torch.no_grad()
def _yogi_leaf(p, m, v, d, lr, beta1, beta2, tau):
    """One leaf of ``yogi_apply``, in place, with the JAX package's
    operations in its order (two temporaries of the leaf's size at most)."""
    if spmd.is_dtensor(m):  # the delta's pending sums land in the optimizer's shards
        d = spmd.redistribute(d, m.placements)
    d = d.to(m.dtype)
    t = d * (1 - beta1)
    m.mul_(beta1).add_(t)
    dd = (d * d).to(v.dtype)
    t = torch.sub(v, dd).sign_()
    dd.mul_(1 - beta2).mul_(t)  # (1 - beta2) · d² · sign(v − d²)
    v.sub_(dd)
    del dd
    t = torch.sqrt(v).add_(tau)
    step = m.float() * lr
    step.div_(t)
    del t
    if p.dtype == torch.float32:
        p.add_(step)
    else:
        p.copy_((p.float() + step).to(p.dtype))


def yogi_apply(params, state, delta, lr=0.02, beta1=0.9, beta2=0.99, tau=1e-3):
    """FedYoGi: m ← β1·m + (1−β1)·Δ; v ← v − (1−β2)·Δ²·sign(v − Δ²);
    p ← p + lr·m/(√v + τ) (``sign(0) = 0``). Updates ``params`` and
    ``state`` in place (the JAX package donates them) and returns both."""
    for p, m, v, d in zip(leaves(params), leaves(state["m"]), leaves(state["v"]), leaves(delta)):
        _yogi_leaf(p, m, v, d, lr, beta1, beta2, tau)
    return params, state


# ---------------------------------------------------------------------------
# Gradients per layer
# ---------------------------------------------------------------------------
def _per_layer(tree, cfg) -> Any:
    """``tree`` (params or a same-shaped state) with every block stack
    (``blocks``; llama4's ``dense_blocks`` and ``moe_blocks``; zamba2's and
    xlstm's nested stacks) split into (nested) lists of per-layer dicts of
    views; zamba2's unstacked shared block stays whole."""
    out = dict(tree)
    bb = dict(tree["backbone"])
    for name, dims in transformer.block_stacks(cfg).items():
        bb[name] = transformer.layers(bb[name], dims)
    out["backbone"] = bb
    return out


def _restacked(split):
    """The inverse of ``transformer.layers``: (nested) lists of per-layer
    trees stacked back into one tree of (n, ...) leaves."""
    if not isinstance(split, list):
        return split
    return tree_map(lambda *g: torch.stack(g), *[_restacked(e) for e in split])


def _flat(tree, cfg) -> List[torch.Tensor]:
    flat: List[torch.Tensor] = []
    tree_map(flat.append, _per_layer(tree, cfg))
    return flat


def _grads(loss_of: Callable, params, cfg):
    """(loss, aux, views, grads): ``loss_of(tree) -> (loss, aux)`` run on
    per-layer leaf tensors that share ``params``' storage; ``views`` are
    those tensors (the parameters' own storage, for in-place updates) and
    ``grads`` their gradients, in one order."""
    views: List[torch.Tensor] = []

    def leaf(a):
        views.append(a.detach().requires_grad_(True))
        return views[-1]

    tree = tree_map(leaf, _per_layer(params, cfg))
    with torch.enable_grad():
        with trace.span("train.forward"):
            loss, aux = loss_of(tree)
        # checkpointed layers run their forward again in here
        with trace.span("train.backward"):
            grads = list(torch.autograd.grad(loss, views))
    # DTensor gradients land in their parameters' layout (pending sums reduced)
    grads = [spmd.redistribute(g, v.placements) if spmd.is_dtensor(g) else g for g, v in zip(grads, views)]
    return loss.detach(), aux, [v.detach() for v in views], grads


def loss_and_grads(model: Model, params, batch, window: int = -1):
    """``jax.value_and_grad(model.loss, has_aux=True)``: ((loss, metrics),
    grads), the grads in ``params``' layout (block leaves stacked, nested
    stacks nested). A block applied more than once (zamba2's shared block)
    gets the sum over its applications."""
    cfg = model.cfg
    loss, aux, _, grads = _grads(lambda t: model.loss(t, batch, window), params, cfg)
    it = iter(grads)
    split = tree_map(lambda a: next(it), _per_layer(params, cfg))
    for name in transformer.block_stacks(cfg):
        split["backbone"][name] = _restacked(split["backbone"][name])
    return (loss, {k: v.detach() for k, v in aux.items()}), split


def _clip_scale(grads: List[torch.Tensor], clip: float) -> torch.Tensor:
    """``min(1, clip / max(‖g‖, 1e-9))`` of the global norm, from float32
    squares (a 0-dim tensor: no host sync)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    return torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)


# ---------------------------------------------------------------------------
# Federated-simulation train step (mode A)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepConfig:
    local_steps: int = 2
    client_lr: float = 0.02
    server_lr: float = 0.02
    clip_norm: float = 1.0  # client-side gradient clipping (0 = off)
    accum_steps: int = 1  # centralized mode: gradient-accumulation microbatches (no step reads it)
    cluster_k: int = 2
    d_sketch: int = 256
    window: int = -1  # attention window override (-1 = config default)


def _client_sum(d: torch.Tensor, ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The (1, C) weighted sum of a (C, ...) delta leaf, one segment
    (``kernels.ops.segment_aggregate`` of the leaf flattened) -> (1, 1, n).
    A DTensor leaf is summed on each card's shard (a sum over client rows is
    column-local): its clients' rows give a ``Partial`` sum over the data
    axes, its split columns a result split alike."""
    if not spmd.is_dtensor(d):
        return kops.segment_aggregate(d.reshape(1, d.shape[0], -1), ids, 1, w)
    mesh = d.device_mesh
    rows = [spmd.shard_dim(p) == 0 and mesh.size(m) > 1 for m, p in enumerate(d.placements)]
    d = spmd.redistribute(d, [p if p.is_shard() else spmd._replicate() for p in d.placements])
    cut = [spmd._shard(1) if r else spmd._replicate() for r in rows]
    ids, w = (spmd.redistribute(spmd.replicate_partial(spmd.as_dtensor(t, mesh)), cut) for t in (ids, w))
    out = [spmd._partial() if r else (spmd._shard(p.dim - 1) if p.is_shard() and p.dim > 0 else spmd._replicate())
           for r, p in zip(rows, d.placements)]

    def fn(dl, il, wl):
        agg = kops.segment_aggregate(dl.reshape(1, dl.shape[0], -1), il, 1, wl)
        return agg.reshape(dl.shape[1:])

    return spmd.local(fn, (d, ids, w), out, mesh)


def make_train_step(model: Model, step_cfg: StepConfig) -> Callable:
    cfg = model.cfg
    sketcher = GradientSketcher(d_sketch=step_cfg.d_sketch, strategy="last_block_proj")

    def sgd(work, micro):
        """One local SGD step on ``work`` in place; returns the loss."""
        loss, _, views, grads = _grads(lambda t: model.loss(t, micro, step_cfg.window), work, cfg)
        with torch.no_grad():
            if step_cfg.clip_norm > 0:
                scale = _clip_scale(grads, step_cfg.clip_norm)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
            for w, g in zip(views, grads):
                w.sub_(g.mul_(step_cfg.client_lr))
        return loss

    def client_update(work, params, batch_c):
        """One client's local training on its working copy ``work`` (filled
        with ``params``), which it leaves holding the client's delta."""
        m = batch_c["tokens"].shape[0]
        ls = step_cfg.local_steps if m % step_cfg.local_steps == 0 else 1
        mb = m // ls
        losses = [sgd(work, {k: a[i * mb:(i + 1) * mb] for k, a in batch_c.items()})
                  for i in range(ls)]
        with torch.no_grad():
            for w, p in zip(leaves(work), leaves(params)):
                w.sub_(p)
        return torch.mean(torch.stack(losses))

    def train_step(params, opt_state, clust_state, batch):
        """One cohort FL round. batch leaves: (C, m, ...). Returns (params,
        opt_state, clust_state, metrics); params and opt_state are the given
        trees, updated in place. On DTensors each card trains the clients of
        its data shard (``spmd.Rows``) with the model split over ``model``."""
        with trace.span("train.round"):
            return fl_round(params, opt_state, clust_state, batch)

    def fl_round(params, opt_state, clust_state, batch):
        rows = spmd.Rows.of(batch["tokens"])
        mine = params if rows is None else tree_map(rows.params, params)
        local = batch if rows is None else {k: rows.local(a) for k, a in batch.items()}
        C = local["tokens"].shape[0]
        with trace.span("train.local"):
            deltas = tree_map(lambda a: spmd.rows_like(a, C), mine)
            losses = []
            for c in range(C):
                work = tree_map(lambda d: d[c], deltas)
                with torch.no_grad():
                    for w, p in zip(leaves(work), leaves(mine)):
                        w.copy_(p)
                losses.append(client_update(work, mine, {k: a[c] for k, a in local.items()}))
            del work  # its views would keep every delta leaf alive below
            losses = torch.stack(losses)
            if rows is not None:  # every card's clients, one tensor split over the data axes
                deltas, losses = tree_map(rows.full, deltas), rows.full(losses)
        C = losses.shape[0]

        with torch.no_grad():
            # per-client gradient sketches (JL projection of the last block)
            sketches = sketcher.batch(deltas)  # (C, d_sketch)
            clust_state, cmetrics = clustering_update(clust_state, sketches)

            # reward-weighted aggregation (robust aggregation, §5.2), one
            # segment sum per leaf into one segment, then FedYoGi on it
            w = torch.clamp(cmetrics["rewards"], min=0.0) + 1e-3
            w = (w / torch.sum(w))[None]
            ids = torch.zeros((1, C), dtype=torch.int32, device=w.device)
            flat_d = leaves(deltas)
            del deltas
            for p, m, v in zip(leaves(params), leaves(opt_state["m"]), leaves(opt_state["v"])):
                d = flat_d.pop(0)
                agg = _client_sum(d, ids, w)
                del d
                _yogi_leaf(p, m, v, agg.reshape(p.shape).to(p.dtype), step_cfg.server_lr,
                           0.9, 0.99, 1e-3)
                del agg
        metrics = {
            "loss": torch.mean(losses),
            "dispersion": cmetrics["dispersion"],
            "cluster_counts": cmetrics["cluster_counts"],
            "reward_mean": torch.mean(cmetrics["rewards"]),
        }
        return params, opt_state, clust_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Centralized train step (mode B)
# ---------------------------------------------------------------------------
def make_central_train_step(model: Model, step_cfg: StepConfig, n_clients: int = 32) -> Callable:
    cfg = model.cfg
    proj_by_device: Dict[str, torch.Tensor] = {}

    def loss_of(batch):
        def fn(tree):
            hidden, aux = transformer.forward_hidden(tree, cfg, batch, step_cfg.window)
            ce = transformer.head_ce(tree, cfg, hidden, batch["tokens"])
            loss = ce + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
            return loss, hidden
        return fn

    def train_step(params, opt_state, clust_state, batch):
        """batch leaves: (B, ...). Params and opt_state are updated in place."""
        loss, hidden, views, grads = _grads(loss_of(batch), params, cfg)

        # per-client sketches: the LM-head gradient w.r.t. the final hidden
        # states, client = contiguous batch group, pooled over tokens,
        # JL-projected (through the head only)
        hidden = hidden.detach()
        B = hidden.shape[0]
        C = min(n_clients, B)
        tok = batch["tokens"]
        head = {k: v for k, v in params.items() if k != "backbone"}
        rows = spmd.Rows.of(hidden)
        if rows is not None:  # each card pools the clients of its batch shard
            hidden, tok, head = rows.local(hidden), rows.local(tok), tree_map(rows.params, head)
            B, C = hidden.shape[0], C // rows.n_data
        hc = hidden.reshape(C, B // C, *hidden.shape[1:])
        tc = tok.reshape(C, B // C, *tok.shape[1:])
        pooled = []
        for c in range(C):
            h = hc[c].clone().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(transformer.head_ce(head, cfg, h, tc[c]), h)
            pooled.append(torch.sum(g.float(), dim=tuple(range(g.dim() - 1))))  # (D,)
        pooled = torch.stack(pooled)  # (C, D)
        if rows is not None:
            pooled = rows.full(spmd.replicate_partial(pooled))
        dev = str(pooled.device)
        if dev not in proj_by_device:
            proj_by_device[dev] = rnd.rademacher(
                rnd.key(1234, device=pooled.device), (cfg.d_model, step_cfg.d_sketch)
            )
        sketches = pooled @ proj_by_device[dev] / math.sqrt(cfg.d_model)

        with torch.no_grad():
            clust_state, cmetrics = clustering_update(clust_state, sketches)
            # the pseudo-delta of one clipped local SGD step (the server
            # optimizer is tuned for client deltas, not raw gradients)
            if step_cfg.clip_norm > 0:
                scale = _clip_scale(grads, step_cfg.clip_norm)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
            flat_m, flat_v = _flat(opt_state["m"], cfg), _flat(opt_state["v"], cfg)
            for p, m, v, g in zip(views, flat_m, flat_v, grads):
                _yogi_leaf(p, m, v, g.mul_(-step_cfg.client_lr), step_cfg.server_lr, 0.9, 0.99, 1e-3)
        metrics = {
            "loss": loss,
            "dispersion": cmetrics["dispersion"],
            "cluster_counts": cmetrics["cluster_counts"],
            "reward_mean": torch.mean(cmetrics["rewards"]),
        }
        return params, opt_state, clust_state, metrics

    return train_step


def jit_train_step(step_fn: Callable) -> Callable:
    """The round step itself. In the JAX package this jits the step with the
    carried state donated, so an async driver holds one live copy of params,
    optimizer and clustering state. The port's steps already run eagerly
    and update the carried params and optimizer state in place, which is
    what donation buys. The JAX package's shardings have their port in
    ``launch.sharding`` (specs and DTensor placements, and the dry run's
    per-card plan); the steps themselves run on one device."""
    return step_fn


# ---------------------------------------------------------------------------
# Prefill / decode steps (serving)
# ---------------------------------------------------------------------------
def make_prefill_step(model: Model, step_cfg: StepConfig) -> Callable:
    """Serving prefill: a full forward, logits of the LAST position only
    (the decode loop continues from there)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, _ = transformer.forward_hidden(params, model.cfg, batch, step_cfg.window)
        return transformer.lm_logits(params, model.cfg, hidden[:, -1:])

    return prefill_step


def make_serve_step(model: Model, step_cfg: StepConfig) -> Callable:
    @torch.no_grad()
    def serve_step(params, cache, batch):
        return model.decode_step(params, batch["tokens"], cache, step_cfg.window)

    return serve_step
