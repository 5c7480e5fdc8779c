"""Synthetic federated datasets with controllable cohort structure.

The container is offline, so the paper's datasets (OpenImage, FEMNIST,
Reddit, …) are replaced by generators whose *population structure* matches
what Auxo exploits: G latent cohorts, each with its own feature transform
(affine shift [61]) and label prior, plus per-client quantity skew and
label-Dirichlet within the cohort. Heterogeneity is a dial:

- ``group_sep``      distance between cohort feature transforms
- ``dirichlet``      within-cohort label concentration (lower = more skew)
- ``affine_shift``   per-client affine feature shift strength (Fig. 13a)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ClientData:
    x: np.ndarray  # (n_i, d)
    y: np.ndarray  # (n_i,)
    group: int  # latent ground-truth cohort (never shown to Auxo)


@dataclasses.dataclass(frozen=True)
class PopulationStructure:
    """The group-level generative structure shared by every client of a
    population: class prototypes, per-group feature transforms, label
    priors, and the label-conflict permutations. Drawn ONCE from a seed
    (``draw_structure``) — both the materialized generator
    (``make_population``) and the streaming ``ProceduralDataPlane``
    consume the same structure, so populations built either way share
    their group geometry exactly."""

    class_means: np.ndarray  # (n_classes, dim)
    group_rot: np.ndarray  # (n_groups, dim, dim)
    group_shift: np.ndarray  # (n_groups, dim)
    group_prior: np.ndarray  # (n_groups, n_classes)
    group_perm: np.ndarray  # (n_groups, n_classes) label-conflict permutation

    @property
    def n_groups(self) -> int:
        return self.group_prior.shape[0]

    @property
    def n_classes(self) -> int:
        return self.class_means.shape[0]

    @property
    def dim(self) -> int:
        return self.class_means.shape[1]


def draw_structure(
    rng: np.random.Generator,
    n_groups: int,
    n_classes: int,
    dim: int,
    group_sep: float,
    label_conflict: float,
) -> PopulationStructure:
    """Draw the group-level structure. The draw ORDER is frozen: it is the
    exact header of the original ``make_population`` stream, so populations
    generated before this refactor are bit-identical."""
    class_means = rng.normal(size=(n_classes, dim))
    class_means *= 2.2 / np.linalg.norm(class_means, axis=1, keepdims=True)

    # per-group affine transforms: rotation + shift, scaled by group_sep
    group_rot = []
    group_shift = []
    for g in range(n_groups):
        q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
        t = group_sep / max(n_groups - 1, 1) * g / 2.0
        rot = (1 - t) * np.eye(dim) + t * q
        group_rot.append(rot)
        group_shift.append(rng.normal(size=dim) * group_sep * 0.4)
    # per-group label priors (distinct dominant classes)
    group_prior = []
    for g in range(n_groups):
        alpha = np.full(n_classes, 0.3)
        dominant = rng.choice(n_classes, size=max(1, n_classes // n_groups), replace=False)
        alpha[dominant] = 6.0
        group_prior.append(rng.dirichlet(alpha))

    # per-group label permutation over a conflict subset of classes
    n_conf = int(round(label_conflict * n_classes))
    conf_classes = rng.choice(n_classes, size=n_conf, replace=False) if n_conf else np.array([], int)
    group_perm = []
    for g in range(n_groups):
        perm = np.arange(n_classes)
        if n_conf > 1:
            shuffled = np.roll(conf_classes, g)  # distinct permutation per group
            perm[conf_classes] = shuffled
        group_perm.append(perm)
    return PopulationStructure(
        class_means=class_means,
        group_rot=np.stack(group_rot),
        group_shift=np.stack(group_shift),
        group_prior=np.stack(group_prior),
        group_perm=np.stack(group_perm),
    )


def sample_group_xy(
    struct: PopulationStructure,
    g: int,
    prior: np.ndarray,
    n: int,
    client_shift: np.ndarray,
    rng: np.random.Generator,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw n (x, y) samples of group ``g`` under a client label prior and
    affine shift — the single xy recipe behind materialized clients, test
    sets, and procedural shards (draw order frozen, see draw_structure)."""
    n_classes = struct.n_classes
    y = rng.choice(n_classes, size=n, p=prior)
    x = struct.class_means[y] + 0.7 * rng.normal(size=(n, struct.dim))
    x = x @ struct.group_rot[g].T + struct.group_shift[g] + client_shift
    y = struct.group_perm[g][y]  # conflicting concepts across groups
    if label_noise > 0:
        flip = rng.random(n) < label_noise
        y = np.where(flip, rng.integers(0, n_classes, size=n), y)
    return x.astype(np.float32), y.astype(np.int32)


@dataclasses.dataclass
class FederatedClassification:
    clients: List[ClientData]
    test_x: Dict[int, np.ndarray]  # per latent group test sets
    test_y: Dict[int, np.ndarray]
    n_classes: int
    dim: int
    n_groups: int
    # generation spec (make_population kwargs) when known — lets
    # checkpoint.save_data_plane persist the POPULATION as a recipe
    # instead of arrays (ARCHITECTURE.md §⑦)
    spec: Optional[dict] = None

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    def client_groups(self) -> np.ndarray:
        return np.array([c.group for c in self.clients])

    def sample_batch(
        self, client_id: int, batch: int, steps: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(steps, batch, d), (steps, batch) with replacement."""
        c = self.clients[client_id]
        idx = rng.integers(0, len(c.y), size=(steps, batch))
        return c.x[idx], c.y[idx]

    def _ensure_flat(self):
        """Build the flat population view: all client data concatenated
        along one sample axis with per-client offsets. Shares dtype/values
        with `clients` (one extra copy of the population, built once)."""
        if getattr(self, "_flat_x", None) is not None:
            return
        self._flat_sizes = np.array([len(c.y) for c in self.clients], np.int64)
        self._flat_offsets = np.concatenate(
            [[0], np.cumsum(self._flat_sizes)[:-1]]
        )
        self._flat_x = np.concatenate([c.x for c in self.clients], axis=0)
        self._flat_y = np.concatenate([c.y for c in self.clients], axis=0)

    def client_sizes(self, client_ids=None) -> np.ndarray:
        """Dataset size per client as one array (no python loop per call)."""
        self._ensure_flat()
        if client_ids is None:
            return self._flat_sizes
        return self._flat_sizes[np.asarray(client_ids, np.int64)]

    def sample_batches(
        self, client_ids, batch: int, steps: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched population sampling: (R, steps, batch, d), (R, steps, batch).

        One vectorized draw for R clients — the round pipeline's data plane
        (`RoundPipeline._pack_rows`) calls this once per round instead of R
        `sample_batch` calls. Row i samples with replacement from client
        `client_ids[i]`'s local data: a single uniform block scaled by each
        client's dataset size, then one fancy-indexed gather from the flat
        population view. Draws differ from the per-client `sample_batch`
        stream (one Generator call instead of R) while being identically
        distributed.
        """
        ids = np.asarray(client_ids, np.int64)
        self._ensure_flat()
        sizes = self._flat_sizes[ids]
        u = rng.random((ids.size, steps, batch))
        # u < 1 strictly, so floor(u * n) <= n - 1: always in range
        idx = (u * sizes[:, None, None]).astype(np.int64)
        g = self._flat_offsets[ids][:, None, None] + idx
        return self._flat_x[g], self._flat_y[g]


def make_population(
    n_clients: int = 400,
    n_groups: int = 4,
    n_classes: int = 10,
    dim: int = 32,
    samples_mean: int = 120,
    group_sep: float = 2.0,
    dirichlet: float = 0.5,
    affine_shift: float = 0.0,
    label_noise: float = 0.0,
    label_conflict: float = 0.0,
    test_per_group: int = 600,
    seed: int = 0,
) -> FederatedClassification:
    """label_conflict: fraction of classes whose label is permuted per group
    — groups then hold *conflicting* concepts (the IFCA/CFL clustered-FL
    setting): a single global model cannot fit all groups simultaneously,
    cohort models can. This is the regime where heterogeneity genuinely
    caps global-model accuracy (paper §2.2)."""
    rng = np.random.default_rng(seed)
    struct = draw_structure(rng, n_groups, n_classes, dim, group_sep, label_conflict)

    clients: List[ClientData] = []
    sizes = np.maximum(8, rng.lognormal(np.log(samples_mean), 0.6, n_clients)).astype(int)
    for i in range(n_clients):
        g = i % n_groups
        prior = rng.dirichlet(dirichlet * n_classes * struct.group_prior[g] + 1e-3)
        client_shift = affine_shift * rng.normal(size=dim)
        x, y = sample_group_xy(
            struct, g, prior, sizes[i], client_shift, rng, label_noise
        )
        clients.append(ClientData(x=x, y=y, group=g))

    test_x, test_y = {}, {}
    for g in range(n_groups):
        x, y = sample_group_xy(
            struct, g, struct.group_prior[g], test_per_group, np.zeros(dim),
            rng, label_noise,
        )
        test_x[g], test_y[g] = x, y

    return FederatedClassification(
        clients=clients,
        test_x=test_x,
        test_y=test_y,
        n_classes=n_classes,
        dim=dim,
        n_groups=n_groups,
        spec=dict(
            n_clients=n_clients,
            n_groups=n_groups,
            n_classes=n_classes,
            dim=dim,
            samples_mean=samples_mean,
            group_sep=group_sep,
            dirichlet=dirichlet,
            affine_shift=affine_shift,
            label_noise=label_noise,
            label_conflict=label_conflict,
            test_per_group=test_per_group,
            seed=seed,
        ),
    )
