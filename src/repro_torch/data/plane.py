"""DataPlane protocol: the engine's ONLY window onto client data.

Copy of ``repro.data.plane`` (numpy only, so the host RNG streams stay
draw-for-draw the same as the JAX package's, and a procedural shard is
byte-equal to the reference's for the same id). Two implementations:

- ``MaterializedDataPlane`` wraps a ``FederatedClassification`` and
  delegates every draw to it verbatim;
- ``ProceduralDataPlane`` never materializes the population: a client's
  shard regenerates ON DEMAND from a hash-seeded PRNG stream
  (id → latent group → client label prior → xy draws), deterministic
  across calls, call orders, and processes. Per-round cost is
  O(participant budget); resident bytes are O(structure + caches),
  INDEPENDENT of N — the seam that lets the full engine run at N = 10⁶.

Protocol surface (everything the engine, pipeline, baselines, eval paths
and benchmarks consume):

  n_clients / n_classes / n_groups / dim
  client_sizes(ids)            per-client dataset sizes (paged cache; the
                               round planner calls this every round —
                               invalidated by churn, see ``invalidate``)
  client_groups(ids)           latent ground-truth group per id (eval only)
  sample_batches(ids, b, s, rng)  (R, steps, batch, d) training draws,
                               with replacement from each id's shard
  probe_batches(ids, b, s)     deterministic per-id draws (serve-time
                               probe fingerprints; own seed per id, never
                               perturbs the training stream)
  eval_batches(groups)         stacked per-group held-out test sets
  invalidate(ids)              churn hook: drop cached per-id state
  data_nbytes                  resident data-plane bytes (scale tripwire)
  plane_spec()                 checkpointable recipe (checkpoint/npz.py
                               persists the SPEC, not arrays)
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.datasets import (
    FederatedClassification,
    PopulationStructure,
    draw_structure,
    sample_group_xy,
)

_U64 = np.uint64
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 ids -> well-mixed uint64."""
    x = (x + _U64(0x9E3779B97F4A7C15)) & _MASK
    x = ((x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)) & _MASK
    x = ((x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)) & _MASK
    return x ^ (x >> _U64(31))


def _mix_key(seed: int, stream: int) -> int:
    """splitmix64 finalizer on python ints (numpy warns on 0-d overflow)."""
    m = 0xFFFFFFFFFFFFFFFF
    x = ((seed * 0x9E37 + stream) + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


def _hash_uniform(seed: int, stream: int, ids: np.ndarray) -> np.ndarray:
    """Deterministic uniforms in [0, 1): one double per id, keyed by
    (seed, stream, id) — no Generator state, identical across processes."""
    h = _splitmix64(ids.astype(np.uint64) ^ _U64(_mix_key(seed, stream)))
    return (h >> _U64(11)).astype(np.float64) * (2.0**-53)


class DataPlane:
    """Abstract base: the paged size cache + the protocol's default hooks.

    ``client_sizes`` is on the per-round hot path (the planner sizes every
    packed row, and the §⑤ overlap packs a round ahead): sizes cache in a
    dict keyed by TOUCHED id — memory tracks participants like the §⑥
    store, never the id range — and churn invalidates via ``invalidate``
    so a re-arrival that changes a client's shard cannot serve a stale
    size.
    """

    n_clients: int
    n_classes: int
    n_groups: int
    dim: int

    def __init__(self):
        self._size_cache: Dict[int, int] = {}
        self._eval_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None

    # ----------------------------------------------------- sizes (cached)
    def _compute_sizes(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def client_sizes(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        cache = self._size_cache
        uniq, inv = np.unique(ids, return_inverse=True)
        vals = np.fromiter(
            (cache.get(int(c), -1) for c in uniq), np.int64, uniq.size
        )
        miss = vals < 0
        if miss.any():
            fresh = self._compute_sizes(uniq[miss])
            vals[miss] = fresh
            cache.update(zip(uniq[miss].tolist(), fresh.tolist()))
        return vals[inv].reshape(ids.shape)

    def invalidate(self, ids):
        """Churn hook: departures/arrivals drop any cached per-id state."""
        for c in np.asarray(ids, np.int64).ravel():
            self._size_cache.pop(int(c), None)

    # ------------------------------------------------------------ protocol
    def client_groups(self, ids) -> np.ndarray:
        raise NotImplementedError

    def sample_batches(
        self, ids, batch: int, steps: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def probe_batches(
        self, ids, batch: int, steps: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _build_eval(self) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked (G, n_eval, d) / (G, n_eval) per-group test sets."""
        raise NotImplementedError

    def eval_batches(
        self, groups: Optional[Sequence[int]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self._eval_cache is None:
            self._eval_cache = self._build_eval()
        tx, ty = self._eval_cache
        if groups is None:
            return tx, ty
        g = np.asarray(groups, np.int64)
        return tx[g], ty[g]

    @property
    def data_nbytes(self) -> int:
        """Resident data-plane bytes (population_scale tripwire)."""
        raise NotImplementedError

    def plane_spec(self) -> Optional[dict]:
        """Checkpointable recipe, or None if the plane holds opaque data."""
        return None


class MaterializedDataPlane(DataPlane):
    """The dense plane: delegates every draw to a ``FederatedClassification``.

    Bit-for-bit contract: each method makes EXACTLY the rng calls the
    engine made before the protocol existed (``sample_batches`` forwards
    to the population's batched draw; ``probe_batches`` reproduces the
    per-id ``default_rng(700_001 + id)`` probe loop), so an engine driven
    through this plane is indistinguishable — draw for draw — from the
    pre-refactor engine. Asserted by tests/test_data_plane.py.
    """

    def __init__(self, pop: FederatedClassification):
        super().__init__()
        self.pop = pop
        self.n_clients = pop.n_clients
        self.n_classes = pop.n_classes
        self.n_groups = pop.n_groups
        self.dim = pop.dim
        self._groups = pop.client_groups()

    def _compute_sizes(self, ids: np.ndarray) -> np.ndarray:
        return self.pop.client_sizes(ids)

    def client_groups(self, ids) -> np.ndarray:
        return self._groups[np.asarray(ids, np.int64)]

    def sample_batches(self, ids, batch, steps, rng):
        return self.pop.sample_batches(ids, batch, steps, rng)

    def probe_batches(self, ids, batch, steps):
        xs, ys = [], []
        for c in ids:  # cheap host draws; the device work batches downstream
            rng = np.random.default_rng(700_001 + int(c))
            x, y = self.pop.sample_batch(int(c), batch, steps, rng)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys)

    def _build_eval(self):
        def stack(arrs):
            # hand-built populations may carry RAGGED per-group test sets:
            # keep them per-group indexable (object array) instead of
            # raising in np.stack — evaluate() indexes tx[g] per group
            if len({a.shape for a in arrs}) == 1:
                return np.stack(arrs)
            out = np.empty(len(arrs), object)
            for i, a in enumerate(arrs):
                out[i] = a
            return out

        return (
            stack([self.pop.test_x[g] for g in range(self.n_groups)]),
            stack([self.pop.test_y[g] for g in range(self.n_groups)]),
        )

    @property
    def data_nbytes(self) -> int:
        # one copy of the population + test sets; the flat sampling view
        # counts only if it was actually built (measuring must not build it)
        flat_x = getattr(self.pop, "_flat_x", None)
        flat = (
            flat_x.nbytes + self.pop._flat_y.nbytes
            if flat_x is not None
            else 0
        )
        return int(
            flat
            + sum(c.x.nbytes + c.y.nbytes for c in self.pop.clients)
            + sum(a.nbytes for a in self.pop.test_x.values())
            + sum(a.nbytes for a in self.pop.test_y.values())
        )

    def plane_spec(self) -> Optional[dict]:
        if self.pop.spec is None:
            return None
        return {"kind": "materialized", **self.pop.spec}


class ProceduralDataPlane(DataPlane):
    """Streaming plane: client shards regenerate from a hash-seeded stream.

    The group-level structure (class prototypes, group transforms/priors,
    conflict permutations) draws ONCE from ``default_rng(seed)`` with the
    exact header stream of ``make_population`` — a procedural and a
    materialized population built from the same spec share their group
    geometry bit-for-bit, and differ only in the per-client draws (hash
    stream vs sequential stream; identically distributed — asserted
    statistically by tests/test_data_plane.py).

    Per client id, deterministically:
      group      = id % n_groups                       (make_population's rule)
      size       = max(8, lognormal(log(samples_mean), 0.6))  via splitmix64
                   uniforms + Box-Muller — vectorized, no Generator
      shard      = default_rng((seed, 0xDA7A, id)): Dirichlet label prior
                   around the group prior, per-client affine shift, then the
                   shared ``sample_group_xy`` recipe for `size` samples

    A bounded LRU keeps the most recent ``shard_cache`` regenerated shards
    (one round's participants typically hit it several times: planner
    sizes, pack draws, probes), so resident bytes stay O(budget), never
    O(N). ``invalidate`` also evicts shards — churn re-arrivals regenerate
    from the hash stream, byte-identical: ids ARE the data plane's table.
    """

    def __init__(
        self,
        n_clients: int,
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
        shard_cache: int = 512,
    ):
        super().__init__()
        self.n_clients = int(n_clients)
        self.n_groups = int(n_groups)
        self.n_classes = int(n_classes)
        self.dim = int(dim)
        self.samples_mean = int(samples_mean)
        self.group_sep = float(group_sep)
        self.dirichlet = float(dirichlet)
        self.affine_shift = float(affine_shift)
        self.label_noise = float(label_noise)
        self.label_conflict = float(label_conflict)
        self.test_per_group = int(test_per_group)
        self.seed = int(seed)
        self.shard_cache = int(shard_cache)
        self.struct: PopulationStructure = draw_structure(
            np.random.default_rng(seed),
            n_groups, n_classes, dim, group_sep, label_conflict,
        )
        self._shards: "OrderedDict[int, Tuple[np.ndarray, np.ndarray]]" = (
            OrderedDict()
        )

    # ------------------------------------------------------------- per-id
    def _compute_sizes(self, ids: np.ndarray) -> np.ndarray:
        u1 = _hash_uniform(self.seed, 0x51, ids)
        u2 = _hash_uniform(self.seed, 0x52, ids)
        z = np.sqrt(-2.0 * np.log(u1 + 1e-300)) * np.cos(2.0 * np.pi * u2)
        sizes = np.exp(math.log(self.samples_mean) + 0.6 * z)
        return np.maximum(8, sizes).astype(np.int64)

    def client_groups(self, ids) -> np.ndarray:
        return np.asarray(ids, np.int64) % self.n_groups

    def _shard(self, c: int) -> Tuple[np.ndarray, np.ndarray]:
        """Client c's full local dataset, regenerated (or LRU-served)."""
        hit = self._shards.get(c)
        if hit is not None:
            self._shards.move_to_end(c)
            return hit
        g = c % self.n_groups
        n = int(self.client_sizes(np.array([c]))[0])
        rng = np.random.default_rng((self.seed, 0xDA7A, c))
        prior = rng.dirichlet(
            self.dirichlet * self.n_classes * self.struct.group_prior[g] + 1e-3
        )
        shift = self.affine_shift * rng.normal(size=self.dim)
        x, y = sample_group_xy(
            self.struct, g, prior, n, shift, rng, self.label_noise
        )
        self._shards[c] = (x, y)
        while len(self._shards) > self.shard_cache:
            self._shards.popitem(last=False)
        return x, y

    # ------------------------------------------------------------ protocol
    def sample_batches(self, ids, batch, steps, rng):
        ids = np.asarray(ids, np.int64)
        sizes = self.client_sizes(ids)
        # same draw shape as the materialized plane: ONE uniform block
        # scaled per client, floor() always in range (u < 1 strictly)
        u = rng.random((ids.size, steps, batch))
        idx = (u * sizes[:, None, None]).astype(np.int64)
        x = np.empty((ids.size, steps, batch, self.dim), np.float32)
        y = np.empty((ids.size, steps, batch), np.int32)
        for i, c in enumerate(ids):
            sx, sy = self._shard(int(c))
            x[i] = sx[idx[i]]
            y[i] = sy[idx[i]]
        return x, y

    def probe_batches(self, ids, batch, steps):
        x = np.empty((len(ids), steps, batch, self.dim), np.float32)
        y = np.empty((len(ids), steps, batch), np.int32)
        for i, c in enumerate(ids):
            sx, sy = self._shard(int(c))
            rng = np.random.default_rng(700_001 + int(c))
            idx = rng.integers(0, sy.size, size=(steps, batch))
            x[i] = sx[idx]
            y[i] = sy[idx]
        return x, y

    def _build_eval(self):
        txs, tys = [], []
        for g in range(self.n_groups):
            rng = np.random.default_rng((self.seed, 0x7E57, g))
            x, y = sample_group_xy(
                self.struct, g, self.struct.group_prior[g],
                self.test_per_group, np.zeros(self.dim), rng,
                self.label_noise,
            )
            txs.append(x)
            tys.append(y)
        return np.stack(txs), np.stack(tys)

    def invalidate(self, ids):
        super().invalidate(ids)
        for c in np.asarray(ids, np.int64):
            self._shards.pop(int(c), None)

    @property
    def data_nbytes(self) -> int:
        struct = sum(
            a.nbytes
            for a in (
                self.struct.class_means, self.struct.group_rot,
                self.struct.group_shift, self.struct.group_prior,
                self.struct.group_perm,
            )
        )
        shards = sum(x.nbytes + y.nbytes for x, y in self._shards.values())
        pages = 16 * len(self._size_cache)  # dict payload, ~2 int64 per id
        ev = (
            sum(a.nbytes for a in self._eval_cache)
            if self._eval_cache is not None
            else 0
        )
        return int(struct + shards + pages + ev)

    def plane_spec(self) -> dict:
        return dict(
            kind="procedural",
            n_clients=self.n_clients,
            n_groups=self.n_groups,
            n_classes=self.n_classes,
            dim=self.dim,
            samples_mean=self.samples_mean,
            group_sep=self.group_sep,
            dirichlet=self.dirichlet,
            affine_shift=self.affine_shift,
            label_noise=self.label_noise,
            label_conflict=self.label_conflict,
            test_per_group=self.test_per_group,
            seed=self.seed,
            shard_cache=self.shard_cache,
        )


def as_plane(population) -> DataPlane:
    """Coerce an engine's ``population`` argument to a DataPlane: planes
    pass through, a FederatedClassification wraps (bit-for-bit)."""
    if isinstance(population, DataPlane):
        return population
    if isinstance(population, FederatedClassification):
        return MaterializedDataPlane(population)
    raise TypeError(
        f"population must be a DataPlane or FederatedClassification, "
        f"got {type(population).__name__}"
    )
