"""Online gradient clustering (paper §4.2, Algorithm 1 lines 13–19).

Port of ``repro.core.clustering``. Per cohort, the first clustering round
runs spherical k-means on the round's sketches; every later round assigns
participants to the nearest prototype by cosine similarity and refreshes
the prototypes with an EMA. The cosine similarities and segment sums go
through ``kernels.ops`` (CUDA kernels on the card). JAX's ``vmap`` over
cohorts and k-means restarts becomes a leading batch axis: one kernel
launch serves every cohort and restart of a call. State tensors live on
the engine's device; the host control plane of the overlapped round
(``assign_and_update_np``, ``_cosine_np``) keeps a state's leaves as numpy
arrays instead (``host_state``), so stage ③ never waits on the card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.kernels import ops as kops


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _center_normalize(sketches: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., P, d) sketches centered on their masked mean, unit-normalized:
    centering removes the shared descent direction."""
    xf = sketches.float()
    tot = torch.clamp(m.sum(-1, keepdim=True), min=1.0)[..., None]
    mu = (xf * m[..., None]).sum(-2, keepdim=True) / tot
    return _normalize(xf - mu)


@dataclasses.dataclass
class ClusterState:
    """Per-cohort clustering state: a dataclass of tensors (a leading C
    axis when stacked)."""

    centroids: torch.Tensor  # (K, d) unit-norm prototypes
    counts: torch.Tensor  # (K,) cumulative assignment counts
    round_counts: torch.Tensor  # (K,) EMA of per-round assignment counts
    dispersion: torch.Tensor  # () EMA of mean (1 - cos to own prototype)
    margin: torch.Tensor  # () EMA of (cos to own) - (cos to best other)
    cluster_dispersion: torch.Tensor  # (K,) per-cluster dispersion EMA
    initialized: torch.Tensor  # () bool
    round: torch.Tensor  # () int32 rounds of clustering performed

    @staticmethod
    def create(k: int, d: int, device=None) -> "ClusterState":
        device = resolve_device(device)
        f = dict(dtype=torch.float32, device=device)
        return ClusterState(
            centroids=torch.zeros((k, d), **f),
            counts=torch.zeros((k,), **f),
            round_counts=torch.zeros((k,), **f),
            dispersion=torch.ones((), **f),
            margin=torch.zeros((), **f),
            cluster_dispersion=torch.ones((k,), **f),
            initialized=torch.zeros((), dtype=torch.bool, device=device),
            round=torch.zeros((), dtype=torch.int32, device=device),
        )


def host_array(a) -> np.ndarray:
    """A state leaf as a numpy array: a tensor is copied to the host (a
    device tensor waits for the card), a numpy leaf passes through."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def host_state(state: ClusterState) -> ClusterState:
    """``state`` with numpy leaves (the host control plane's form)."""
    return ClusterState(**{
        f.name: host_array(getattr(state, f.name)) for f in dataclasses.fields(ClusterState)
    })


def stack_states(states: Sequence[ClusterState]) -> ClusterState:
    """Stack per-cohort states into one ClusterState with a leading C axis."""
    return ClusterState(**{
        f.name: torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(ClusterState)
    })


def unstack_states(stacked: ClusterState, n: int) -> List[ClusterState]:
    """Split a leading-C-axis ClusterState into per-cohort views."""
    return [
        ClusterState(**{f.name: getattr(stacked, f.name)[i] for f in dataclasses.fields(ClusterState)})
        for i in range(n)
    ]


# ---------------------------------------------------------------- k-means
def kmeans_bootstrap_batched(
    keys: torch.Tensor, sketches: torch.Tensor, masks: torch.Tensor, k: int,
    iters: int = 10, restarts: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means (cosine) for C cohorts at once, ``restarts``
    seedings each, keeping the restart with the highest mean cosine to the
    assigned prototype. keys (C, 2), sketches (C, P, d), masks (C, P) ->
    (centroids (C, K, d), assignments (C, P)). Cohorts and restarts fold
    into the kernels' leading axis (C·R)."""
    C, P, d = sketches.shape
    R = restarts
    dev = sketches.device
    m = masks.float()
    x = _center_normalize(sketches, m)  # (C, P, d)
    sub_keys = rnd.split(keys, R) if R > 1 else keys[:, None]  # (C, R, 2)
    xr = x[:, None].expand(C, R, P, d).reshape(C * R, P, d).contiguous()
    mr = m[:, None].expand(C, R, P).reshape(C * R, P).contiguous()
    key = sub_keys.reshape(C * R, 2)

    # k-means++ style seeding on the sphere
    spl = rnd.split(key)
    key, sub = spl[:, 0], spl[:, 1]
    u = rnd.uniform(sub, (P,))  # (CR, P)
    first = torch.argmax(mr * u, dim=1)
    rows = torch.arange(C * R, device=dev)
    cents = torch.zeros((C * R, k, d), dtype=torch.float32, device=dev)
    cents[:, 0] = xr[rows, first]
    kk = torch.arange(k, device=dev)
    for i in range(1, k):
        sims = kops.cosine_similarity(xr, cents)  # (CR, P, K)
        chosen = kk < i
        d2 = (1.0 - torch.amax(torch.where(chosen, sims, -1.0), dim=2)) * mr
        spl = rnd.split(key)
        key, sub = spl[:, 0], spl[:, 1]
        idx = rnd.categorical(sub, torch.log(torch.clamp(d2, min=1e-9)))
        cents[:, i] = xr[rows, idx]

    for _ in range(iters):  # Lloyd steps
        sims = kops.cosine_similarity(xr, cents)
        assign = torch.argmax(sims, dim=2)
        sums = kops.segment_aggregate(xr, assign, k, weights=mr)  # (CR, K, d)
        empty = torch.linalg.vector_norm(sums, dim=2, keepdim=True) < 1e-8
        cents = torch.where(empty, cents, _normalize(sums))
    sims = kops.cosine_similarity(xr, cents)
    assign = torch.argmax(sims, dim=2)  # (CR, P)

    if R == 1:
        return cents.reshape(C, k, d), assign.reshape(C, P)
    # restart objective: weighted mean cos to own prototype
    picked = torch.gather(sims, 2, assign[..., None])[..., 0]
    scores = (picked * mr).sum(1) / torch.clamp(mr.sum(1), min=1.0)
    best = torch.argmax(scores.reshape(C, R), dim=1)
    ci = torch.arange(C, device=dev)
    return (
        cents.reshape(C, R, k, d)[ci, best],
        assign.reshape(C, R, P)[ci, best],
    )


def kmeans_cosine(key, sketches, k: int, iters: int = 10, mask=None, restarts: int = 4):
    """One cohort's spherical k-means: (P, d) -> ((K, d), (P,))."""
    m = torch.ones(sketches.shape[0], device=sketches.device) if mask is None else mask
    cents, assign = kmeans_bootstrap_batched(
        key[None], sketches[None], m[None], k, iters, restarts
    )
    return cents[0], assign[0]


# ---------------------------------------------------- assignment + EMA
def assign_and_update_batched(
    state: ClusterState, sketches: torch.Tensor, mask: torch.Tensor, ema: float = 0.3
) -> Tuple[ClusterState, torch.Tensor, torch.Tensor]:
    """Alg. 1 lines 17–19 for C cohorts in one pass: nearest-prototype
    assignment + EMA refresh. state has (C, ...) leaves, sketches (C, P, d),
    mask (C, P) -> (new state, assignments (C, P), sims (C, P, K))."""
    m = mask.float()
    k = state.centroids.shape[1]
    x = _center_normalize(sketches, m)
    sims = kops.cosine_similarity(x, state.centroids)  # (C, P, K)
    assign = torch.argmax(sims, dim=2)

    sums = kops.segment_aggregate(x, assign, k, weights=m)  # (C, K, d)
    counts = kops.segment_aggregate(m[..., None], assign, k)[..., 0]  # (C, K)
    batch_cent = torch.where(
        counts[..., None] > 0, sums / torch.clamp(counts[..., None], min=1.0), state.centroids
    )
    new_cents = _normalize((1 - ema) * state.centroids + ema * batch_cent)

    tot = torch.clamp(m.sum(1), min=1.0)
    picked = torch.gather(sims, 2, assign[..., None])[..., 0]
    disp = 1.0 - (picked * m).sum(1) / tot
    new_disp = 0.8 * state.dispersion + 0.2 * disp

    # separation margin: own-centroid sim minus best other-centroid sim;
    # one-cluster states have margin 0 by construction
    own = torch.nn.functional.one_hot(assign, k).bool()
    second = torch.amax(torch.where(own, -torch.inf, sims), dim=2)
    second = torch.where(torch.isfinite(second), second, picked)
    marg = ((picked - second) * m).sum(1) / tot
    new_margin = 0.8 * state.margin + 0.2 * marg

    per_cl = kops.segment_aggregate(((1.0 - picked) * m)[..., None], assign, k)[..., 0]
    per_cl = torch.where(counts > 0, per_cl / torch.clamp(counts, min=1.0), state.cluster_dispersion)
    new_cl_disp = torch.where(
        counts > 0, 0.8 * state.cluster_dispersion + 0.2 * per_cl, state.cluster_dispersion
    )
    new_state = dataclasses.replace(
        state,
        centroids=new_cents,
        counts=state.counts + counts,
        round_counts=0.7 * state.round_counts + 0.3 * counts,
        dispersion=new_disp,
        margin=new_margin,
        cluster_dispersion=new_cl_disp,
        round=state.round + 1,
    )
    return new_state, assign, sims


def assign_and_update(
    state: ClusterState, sketches: torch.Tensor, mask=None, ema: float = 0.3
) -> Tuple[ClusterState, torch.Tensor, torch.Tensor]:
    """One cohort's assignment + EMA refresh: (P, d) -> (state, (P,), (P, K))."""
    m = torch.ones(sketches.shape[0], device=sketches.device) if mask is None else mask
    st, a, s = assign_and_update_batched(stack_states([state]), sketches[None], m[None], ema)
    return unstack_states(st, 1)[0], a[0], s[0]


def _cosine_np(x: np.ndarray, c: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Numpy twin of kernels.ref.cosine_similarity: (P,D),(K,D) -> (P,K)."""
    x = np.asarray(x, np.float32)
    c = np.asarray(c, np.float32)
    dots = x @ c.T
    xn = np.linalg.norm(x, axis=1, keepdims=True)
    cn = np.linalg.norm(c, axis=1, keepdims=True)
    return dots / np.maximum(xn * cn.T, eps)


def assign_and_update_np(
    state: ClusterState, sketches: np.ndarray, mask=None, ema: float = 0.3
) -> Tuple[ClusterState, np.ndarray, np.ndarray]:
    """Numpy twin of ``assign_and_update`` for the HOST control plane
    (verbatim copy of the JAX package's twin).

    The §⑤ overlapped round pipeline keeps stage ③ on the host: a kernel
    launch here would queue behind the in-flight fused round step and its
    result fetch would serialize the pipeline. The per-round arrays are
    tiny ((P ≤ 64, d_sketch) per cohort). Same math as the device path,
    ulp-level float differences aside; returns a ClusterState with numpy
    leaves (a tensor state is copied to the host first).
    """
    state = host_state(state)
    x = np.asarray(sketches, np.float32)
    cents = np.asarray(state.centroids, np.float32)
    k = cents.shape[0]
    m = (
        np.ones((x.shape[0],), np.float32)
        if mask is None
        else np.asarray(mask, np.float32)
    )
    tot = max(float(m.sum()), 1.0)
    mu = (x * m[:, None]).sum(0, keepdims=True) / tot
    xc = x - mu
    xn = xc / (np.linalg.norm(xc, axis=-1, keepdims=True) + 1e-8)
    sims = _cosine_np(xn, cents)  # (P, K)
    assign = np.argmax(sims, axis=1).astype(np.int32)

    onehot = (assign[:, None] == np.arange(k)[None, :]).astype(np.float32)
    wcol = onehot * m[:, None]  # (P, K)
    sums = wcol.T @ xn  # (K, d)
    counts = wcol.sum(0)  # (K,)
    batch_cent = np.where(
        counts[:, None] > 0, sums / np.maximum(counts[:, None], 1.0), cents
    )
    new_cents = (1 - ema) * cents + ema * batch_cent
    new_cents /= np.linalg.norm(new_cents, axis=-1, keepdims=True) + 1e-8

    rows = np.arange(x.shape[0])
    picked = sims[rows, assign]
    disp = 1.0 - float((picked * m).sum()) / tot
    new_disp = 0.8 * np.float32(state.dispersion) + 0.2 * np.float32(disp)

    others = np.where(onehot.astype(bool), -np.inf, sims)
    second = others.max(axis=1)
    second = np.where(np.isfinite(second), second, picked)
    marg = float(((picked - second) * m).sum()) / tot
    new_margin = 0.8 * np.float32(state.margin) + 0.2 * np.float32(marg)

    per_cl = (onehot * ((1.0 - picked) * m)[:, None]).sum(0)
    old_cl = np.asarray(state.cluster_dispersion, np.float32)
    per_cl = np.where(counts > 0, per_cl / np.maximum(counts, 1.0), old_cl)
    new_cl_disp = np.where(counts > 0, 0.8 * old_cl + 0.2 * per_cl, old_cl)

    new_state = dataclasses.replace(
        state,
        centroids=new_cents.astype(np.float32),
        counts=np.asarray(state.counts, np.float32) + counts,
        round_counts=0.7 * np.asarray(state.round_counts, np.float32) + 0.3 * counts,
        dispersion=np.float32(new_disp),
        margin=np.float32(new_margin),
        cluster_dispersion=new_cl_disp.astype(np.float32),
        round=np.asarray(state.round, np.int32) + 1,
    )
    return new_state, assign, sims


def population_heterogeneity(sketches: torch.Tensor, mask=None) -> torch.Tensor:
    """Eq. (1) intra-heterogeneity J: variance around the masked mean."""
    x = sketches.float()
    m = torch.ones(x.shape[0], device=x.device) if mask is None else mask.float()
    tot = torch.clamp(m.sum(), min=1.0)
    mu = (x * m[:, None]).sum(0, keepdim=True) / tot
    return (m * ((x - mu) ** 2).sum(-1)).sum() / tot


class OnlineClustering:
    """Host-side wrapper implementing Algorithm 1's ClientClustering()."""

    def __init__(self, k: int, d_sketch: int, ema: float = 0.3, seed: int = 0, device=None):
        self.k = k
        self.d_sketch = d_sketch
        self.device = resolve_device(device)
        self.state = ClusterState.create(k, d_sketch, self.device)
        self.ema = ema
        self._key = rnd.key(seed, device=self.device)

    def step(self, sketches: torch.Tensor, mask=None) -> Tuple[np.ndarray, np.ndarray]:
        """One clustering round. sketches: (P, d), mask: optional (P,).
        Returns (assign, sims) over all P rows as numpy arrays."""
        if sketches.shape[0] == 0:
            return np.zeros((0,), np.int32), np.zeros((0, self.k), np.float32)
        if not bool(self.state.initialized):
            self._key, sub = rnd.split(self._key)
            cents, assign = kmeans_cosine(sub, sketches, self.k, mask=mask)
            self.state = dataclasses.replace(
                self.state,
                centroids=cents,
                initialized=torch.ones((), dtype=torch.bool, device=self.device),
                round=self.state.round + 1,
            )
            m = torch.ones(sketches.shape[0], device=sketches.device) if mask is None else mask.float()
            sims = kops.cosine_similarity(_center_normalize(sketches, m), cents)
            return assign.cpu().numpy(), sims.cpu().numpy()
        self.state, assign, sims = assign_and_update(self.state, sketches, mask, self.ema)
        return assign.cpu().numpy(), sims.cpu().numpy()

    @property
    def dispersion(self) -> float:
        return float(self.state.dispersion)

    @property
    def rounds(self) -> int:
        return int(self.state.round)

    def cluster_sizes(self) -> np.ndarray:
        return host_array(self.state.round_counts)

    def cluster_dispersions(self) -> np.ndarray:
        return host_array(self.state.cluster_dispersion)

    @property
    def margin(self) -> float:
        return float(self.state.margin)
