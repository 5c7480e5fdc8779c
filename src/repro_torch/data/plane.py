"""DataPlane protocol: the engine's ONLY window onto client data.

Copy of ``repro.data.plane`` (numpy only, so the host RNG streams stay
draw-for-draw the same as the JAX package's). This slice keeps the
protocol and ``MaterializedDataPlane``, which wraps a
``FederatedClassification`` and delegates every draw to it verbatim; the
streaming ``ProceduralDataPlane`` comes with the population-store slice.

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

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.datasets import FederatedClassification


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
