"""Chunked client-state store: population size as a streaming quantity.

The control plane before this module was dense in ``n_clients``: the
affinity tables allocated ``(N, capacity)`` blocks, fingerprints an
``(N, d_sketch)`` block, and every partition reseed or availability draw
walked the whole population. None of that survives the ROADMAP's
"millions of users" target — per-round host cost and resident memory must
scale with the *active set* (the clients a round actually touches), not
with N.

``PopulationStore`` keeps per-client soft state in fixed-size chunks of
rows, where a row is allocated on a client's FIRST WRITE, in touch order:

- ``rows_of(ids)``      — compact id→row index: paged int32 tables
                          (one page covers 2^16 ids, materialized only for
                          id ranges that contain touched clients);
- ``take``/``put``      — gather/scatter a field for a batch of rows;
  (``gather``/``scatter`` are the id-keyed forms.) Reads of never-touched
  ids return the field's default WITHOUT materializing anything, so a
  round's participants are the only clients that ever cost memory;
- ``depart``/``arrive`` — churn: a departure wipes the row back to
  defaults (exploration restarts from scratch, §5.2 soft-state loss) and
  flags the client out of the sampling population; a re-arrival is a cold
  start — no fingerprint, so serving routes it through the
  probe-fingerprint path like any never-trained client.

``ChunkedAffinityTable`` mirrors ``fl.pipeline.AffinityTable``'s method
API over a store: every method applies the same dtype math to the same
cells, so small-N runs through the store are bit-for-bit identical to the
dense path (asserted by tests/test_population_scale.py). Partition
reseeds (``seed_children``) iterate only materialized chunks — clients
the run never touched hold no reward record to reseed, so the rewrite is
lazy by construction.

``ClientField`` and the probe caches are the engine-facing views: numpy
fancy-index semantics (``field[ids]``, ``field[ids] = v``, augmented
assignment) over either backing, so the engine's hot paths are identical
in dense and chunked mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One per-client field: ``shape`` is the per-client tail (() = scalar)."""

    name: str
    shape: Tuple[int, ...]
    dtype: Any
    default: Any = 0


class PopulationStore:
    """Fixed-size-chunk store of per-client soft state, O(touched) memory.

    Rows live in chunks of ``chunk_rows``; the id→row index is paged
    (``PAGE_BITS``) so index memory also tracks the touched id ranges, not
    the population bound. ``n_base`` is the initial population size;
    ``n_total`` grows if churn arrivals introduce ids beyond it.
    """

    PAGE_BITS = 16

    def __init__(
        self,
        fields: Sequence[FieldSpec],
        n_clients: int,
        chunk_rows: int = 4096,
    ):
        self._specs: Dict[str, FieldSpec] = {f.name: f for f in fields}
        self.chunk_rows = int(chunk_rows)
        self.n_base = int(n_clients)
        self.n_total = int(n_clients)
        self._chunks: Dict[str, List[np.ndarray]] = {
            f.name: [] for f in fields
        }
        self._owner: List[np.ndarray] = []  # per chunk: row -> client id (-1 free)
        self._pages: Dict[int, np.ndarray] = {}  # page idx -> int32 row table
        self.n_rows = 0  # allocated (touched) rows
        self.n_departed = 0

    # ------------------------------------------------------------- layout
    @property
    def field_names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def spec(self, name: str) -> FieldSpec:
        return self._specs[name]

    @property
    def row_nbytes(self) -> int:
        """Bytes of one fully-materialized client row across all fields."""
        return sum(
            int(np.prod(f.shape, dtype=np.int64)) * np.dtype(f.dtype).itemsize
            for f in self._specs.values()
        ) + 8  # + the owner entry

    @property
    def nbytes(self) -> int:
        """Resident client-state bytes: chunks + owner maps + index pages."""
        chunks = sum(
            a.nbytes for per in self._chunks.values() for a in per
        )
        owner = sum(a.nbytes for a in self._owner)
        pages = sum(a.nbytes for a in self._pages.values())
        return chunks + owner + pages

    def chunk_views(self, names: Sequence[str]) -> Iterator[Tuple[np.ndarray, ...]]:
        """Iterate materialized chunks as per-field array tuples (mutable)."""
        for arrs in zip(*(self._chunks[n] for n in names)):
            yield arrs

    def chunks(self, name: str) -> List[np.ndarray]:
        return self._chunks[name]

    # -------------------------------------------------------------- index
    def rows_of(self, ids, allocate: bool = False) -> np.ndarray:
        """Rows of `ids` (-1 = never touched). ``allocate=True`` assigns
        fresh rows to the misses, in order — ids must then be unique."""
        ids = np.asarray(ids, np.int64)
        rows = np.full(ids.shape, -1, np.int64)
        if ids.size == 0:
            return rows
        pg = ids >> self.PAGE_BITS
        off = ids & ((1 << self.PAGE_BITS) - 1)
        for p in np.unique(pg):
            page = self._pages.get(int(p))
            if page is None:
                continue
            m = pg == p
            rows[m] = page[off[m]]
        if allocate:
            miss = np.flatnonzero(rows < 0)
            if miss.size:
                rows[miss] = self._alloc(ids[miss])
        return rows

    def _alloc(self, ids: np.ndarray) -> np.ndarray:
        rows = np.arange(self.n_rows, self.n_rows + ids.size, dtype=np.int64)
        self.n_rows += ids.size
        while len(self._owner) * self.chunk_rows < self.n_rows:
            for f in self._specs.values():
                self._chunks[f.name].append(
                    np.full((self.chunk_rows,) + f.shape, f.default, f.dtype)
                )
            self._owner.append(np.full(self.chunk_rows, -1, np.int64))
        ci, li = np.divmod(rows, self.chunk_rows)
        for c in np.unique(ci):
            m = ci == c
            self._owner[c][li[m]] = ids[m]
        pg = ids >> self.PAGE_BITS
        off = ids & ((1 << self.PAGE_BITS) - 1)
        for p in np.unique(pg):
            page = self._pages.setdefault(
                int(p), np.full(1 << self.PAGE_BITS, -1, np.int32)
            )
            m = pg == p
            page[off[m]] = rows[m]
        if ids.size and int(ids.max()) >= self.n_total:
            self.n_total = int(ids.max()) + 1
        return rows

    # ----------------------------------------------------- gather/scatter
    def take(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Gather a field by row (-1 rows yield the default). Returns a copy."""
        f = self._specs[name]
        out = np.full((rows.size,) + f.shape, f.default, f.dtype)
        ok = rows >= 0
        if ok.any():
            r = rows[ok]
            dst = np.flatnonzero(ok)
            ci, li = np.divmod(r, self.chunk_rows)
            for c in np.unique(ci):
                m = ci == c
                out[dst[m]] = self._chunks[name][c][li[m]]
        return out

    def put(self, name: str, rows: np.ndarray, values):
        """Scatter a field by row (all rows must be allocated, i.e. >= 0)."""
        f = self._specs[name]
        vals = np.broadcast_to(
            np.asarray(values, f.dtype), (rows.size,) + f.shape
        )
        ci, li = np.divmod(rows, self.chunk_rows)
        for c in np.unique(ci):
            m = ci == c
            self._chunks[name][c][li[m]] = vals[m]

    def gather(self, name: str, ids) -> np.ndarray:
        return self.take(name, self.rows_of(ids))

    def scatter(self, name: str, ids, values):
        self.put(name, self.rows_of(ids, allocate=True), values)

    def fill(self, name: str, value):
        """Set a field to `value` across every materialized chunk."""
        for a in self._chunks[name]:
            a[...] = value

    def to_dense(self, name: str, n: Optional[int] = None) -> np.ndarray:
        """Materialize a field as a dense (n, ...) block (tests/debug only)."""
        f = self._specs[name]
        n = self.n_total if n is None else int(n)
        out = np.full((n,) + f.shape, f.default, f.dtype)
        for c, own in enumerate(self._owner):
            m = (own >= 0) & (own < n)
            out[own[m]] = self._chunks[name][c][m]
        return out

    # --------------------------------------------------------------- churn
    def depart(self, ids):
        """Client departures: wipe soft state, remove from the population.

        The wiped row keeps its allocation (the ``departed`` flag must be
        remembered); all other fields reset to defaults, so a later
        re-arrival is a genuine cold start.
        """
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        assert "departed" in self._specs, "store was built without churn fields"
        rows = self.rows_of(ids, allocate=True)
        was = self.take("departed", rows)
        for f in self._specs.values():
            if f.name != "departed":
                self.put(f.name, rows, f.default)
        self.put("departed", rows, True)
        self.n_departed += int((~was).sum())

    def arrive(self, ids):
        """Arrivals/re-arrivals: join the sampling population cold.

        Re-arrivals (rows flagged departed) re-wipe their soft state here:
        an overlapped round (§⑤) in flight at departure time can deliver
        late feedback that re-writes a wiped row, and the cold-start
        contract must hold at ARRIVAL, not only at departure.
        """
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        assert "departed" in self._specs, "store was built without churn fields"
        rows = self.rows_of(ids, allocate=True)
        was = self.take("departed", rows)
        back = rows[was]
        if back.size:
            for f in self._specs.values():
                if f.name != "departed":
                    self.put(f.name, back, f.default)
            if "rearrived" in self._specs:
                # mark GENUINE re-arrivals (rows that had departed) so the
                # warm-rearrival matching policy (FLConfig.warm_rearrivals)
                # can seed their first check-in from a probe fingerprint
                self.put("rearrived", back, True)
        self.put("departed", rows, False)
        self.n_departed -= int(was.sum())

    def alive(self, ids) -> np.ndarray:
        """Membership mask: in [0, n_total) and not departed."""
        ids = np.asarray(ids, np.int64)
        ok = (ids >= 0) & (ids < self.n_total)
        if "departed" in self._specs and self.n_departed:
            ok &= ~self.gather("departed", ids)
        return ok


def make_client_store(
    n_clients: int, d_sketch: int, capacity: int, chunk_rows: int = 4096
) -> PopulationStore:
    """The engine's client-state schema: affinity records, fingerprint EMA,
    negative-streak counters, serve-time probe cache, churn flag."""
    fields = [
        FieldSpec("reward", (capacity,), np.float32, 0.0),
        FieldSpec("known", (capacity,), np.bool_, False),
        FieldSpec("cluster_idx", (capacity,), np.int32, -1),
        FieldSpec("fingerprint", (d_sketch,), np.float32, 0.0),
        FieldSpec("fp_seen", (), np.bool_, False),
        FieldSpec("neg_streak", (), np.int32, 0),
        FieldSpec("probe_fp", (d_sketch,), np.float32, 0.0),
        FieldSpec("probe_seen", (), np.bool_, False),
        FieldSpec("departed", (), np.bool_, False),
        # re-arrival marker: set when a departed row returns, consumed
        # (one-shot) by the warm-rearrival matching policy
        FieldSpec("rearrived", (), np.bool_, False),
    ]
    return PopulationStore(fields, n_clients=n_clients, chunk_rows=chunk_rows)


def remap_affinity_slots(
    store: PopulationStore,
    old_slots: np.ndarray,
    new_slots: np.ndarray,
    new_capacity: int,
):
    """Re-pack the affinity columns of a store to a new bank slot layout.

    The reward/known/cluster_idx fields carry one column per bank slot, and
    slot ids are a function of the shard count (ARCHITECTURE.md §⑨ remesh):
    restoring a checkpoint onto a different ``cohort_shards`` moves live
    column ``old_slots[i]`` to ``new_slots[i]`` and resizes the fields to
    the new padded capacity. In-place over every materialized chunk —
    columns no allocation maps to reset to the field default, exactly the
    state of never-trained slots. Non-affinity fields are untouched.
    """
    old = np.asarray(old_slots, np.int64)
    new = np.asarray(new_slots, np.int64)
    assert old.shape == new.shape, (old.shape, new.shape)
    new_capacity = int(new_capacity)
    assert new.size == 0 or int(new.max()) < new_capacity
    for name in ChunkedAffinityTable.FIELDS:
        f = store._specs[name]
        store._specs[name] = dataclasses.replace(f, shape=(new_capacity,))
        chunks = store._chunks[name]
        for i, ch in enumerate(chunks):
            out = np.full((ch.shape[0], new_capacity), f.default, f.dtype)
            out[:, new] = ch[:, old]
            chunks[i] = out


def adopt_store_state(dst: PopulationStore, src: PopulationStore):
    """Move `src`'s entire state into `dst` IN PLACE.

    Restore path (checkpoint.run_state): every engine-held view — the
    ChunkedAffinityTable, ClientFields, StoreProbeCache — keeps a reference
    to the engine's store object, so a checkpoint load must mutate that
    object rather than swap it. The adopted field set must match what the
    views expect (asserted for the affinity fields by the caller).
    """
    dst._specs = src._specs
    dst._chunks = src._chunks
    dst._owner = src._owner
    dst._pages = src._pages
    dst.n_rows = src.n_rows
    dst.n_total = src.n_total
    dst.n_departed = src.n_departed
    dst.n_base = src.n_base
    dst.chunk_rows = src.chunk_rows


class ClientField:
    """numpy-flavored view of one store field, keyed by client id.

    Supports the engine's access patterns: ``f[ids]`` gathers (defaults
    for never-touched ids, no materialization), ``f[ids] = v`` scatters
    (allocating rows), and therefore augmented assignment
    (``f[ids] += 1`` = gather → op → scatter). Scalar ids return a single
    row. Scatter ids must be unique.
    """

    def __init__(self, store: PopulationStore, name: str):
        self.store = store
        self.name = name

    def __getitem__(self, ids):
        if np.ndim(ids) == 0:
            return self.store.gather(self.name, np.asarray([ids], np.int64))[0]
        return self.store.gather(self.name, ids)

    def __setitem__(self, ids, value):
        if np.ndim(ids) == 0:
            ids = np.asarray([ids], np.int64)
        self.store.scatter(self.name, ids, value)

    def to_dense(self, n: Optional[int] = None) -> np.ndarray:
        return self.store.to_dense(self.name, n)


class DictProbeCache(dict):
    """Plain-dict probe-fingerprint cache (the dense small-N engines)."""

    def missing(self, cs) -> np.ndarray:
        return np.array([c for c in cs if int(c) not in self], np.int64)

    def put(self, cs, rows: np.ndarray):
        for j, c in enumerate(cs):
            self[int(c)] = rows[j]

    def get_many(self, cs) -> np.ndarray:
        return np.stack([self[int(c)] for c in cs])

    def drop(self, cs):
        """Invalidate entries for churned ids (departures / re-arrivals)."""
        for c in cs:
            self.pop(int(c), None)


class StoreProbeCache:
    """Store-backed probe-fingerprint cache: same protocol as DictProbeCache
    (missing/put/get_many/pop/clear/contains), state in probe_fp/probe_seen
    rows so cached probes cost memory only for the clients that probed."""

    def __init__(self, store: PopulationStore):
        self.store = store

    def missing(self, cs) -> np.ndarray:
        cs = np.asarray(cs, np.int64)
        return cs[~self.store.gather("probe_seen", cs)]

    def put(self, cs, rows: np.ndarray):
        cs = np.asarray(cs, np.int64)
        if cs.size == 0:
            return
        r = self.store.rows_of(cs, allocate=True)
        self.store.put("probe_fp", r, rows)
        self.store.put("probe_seen", r, True)

    def get_many(self, cs) -> np.ndarray:
        return self.store.gather("probe_fp", cs)

    def pop(self, c, default=None):
        r = self.store.rows_of(np.asarray([c], np.int64))
        if r[0] >= 0 and bool(self.store.take("probe_seen", r)[0]):
            out = self.store.take("probe_fp", r)[0]
            self.store.put("probe_seen", r, False)
            return out
        return default

    def drop(self, cs):
        """Invalidate entries for churned ids (departures / re-arrivals).

        `depart` happens to wipe probe rows with the rest of the record,
        but churn-time invalidation is a CONTRACT of the probe cache (a
        re-arrival must re-probe cold), not an accident of the store's
        wipe set — so it is explicit here, and only touches materialized
        rows (an id without a row has nothing cached).
        """
        cs = np.asarray(cs, np.int64)
        if cs.size == 0:
            return
        r = self.store.rows_of(cs)
        r = r[r >= 0]
        if r.size:
            self.store.put("probe_seen", r, False)

    def clear(self):
        self.store.fill("probe_seen", False)

    def __contains__(self, c) -> bool:
        return bool(self.store.gather("probe_seen", np.asarray([c], np.int64))[0])

    def __len__(self) -> int:
        return int(sum(a.sum() for a in self.store.chunks("probe_seen")))

    def __bool__(self) -> bool:
        return len(self) > 0


class ChunkedAffinityTable:
    """``fl.pipeline.AffinityTable``'s method API over a PopulationStore.

    Every method applies the SAME dtype arithmetic to the same cells as the
    dense table — runs through either backing are bit-for-bit identical;
    only memory layout and cost model differ (O(touched rows), and
    ``seed_children`` — the partition reseed — walks materialized chunks
    only: a client without a reward record has nothing to reseed).
    """

    FIELDS = ("reward", "known", "cluster_idx")

    def __init__(self, store: PopulationStore):
        self.store = store
        self.capacity = int(store.spec("reward").shape[0])

    # ------------------------------------------------------ bulk row forms
    def gather_rows(self, cids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows = self.store.rows_of(np.asarray(cids, np.int64))
        return tuple(self.store.take(f, rows) for f in self.FIELDS)

    def scatter_rows(self, cids, reward, known, cluster_idx):
        rows = self.store.rows_of(np.asarray(cids, np.int64), allocate=True)
        for f, v in zip(self.FIELDS, (reward, known, cluster_idx)):
            self.store.put(f, rows, v)

    def match_view(self, cids, slots) -> Tuple[np.ndarray, np.ndarray]:
        """(reward, known) blocks over (cids × slots) — read-only copies."""
        rw, kn, _ = self.gather_rows(cids)
        return rw[:, slots], kn[:, slots]

    def known_at(self, cids, slot) -> np.ndarray:
        rows = self.store.rows_of(np.asarray(cids, np.int64))
        return self.store.take("known", rows)[:, slot]

    def cluster_at(self, c, slot) -> int:
        rows = self.store.rows_of(np.asarray([c], np.int64))
        return int(self.store.take("cluster_idx", rows)[0, slot])

    # --------------------------------------------------- AffinityTable ops
    def wipe(self, cids):
        cids = np.asarray(cids, np.int64)
        if cids.size == 0:
            return
        rows = self.store.rows_of(cids, allocate=True)
        for f in self.FIELDS:
            self.store.put(f, rows, self.store.spec(f).default)

    def feedback(self, cids, slot, delta, gamma: float):
        cids = np.asarray(cids, np.int64)
        if cids.size == 0:
            return
        rows = self.store.rows_of(cids, allocate=True)
        rw = self.store.take("reward", rows)
        kn = self.store.take("known", rows)
        rw[:, slot] = gamma * delta + (1.0 - gamma) * rw[:, slot]
        kn[:, slot] = True
        self.store.put("reward", rows, rw)
        self.store.put("known", rows, kn)

    def set_cluster(self, cids, slot, assign):
        has = assign >= 0
        sub = np.asarray(cids, np.int64)[has]
        if sub.size == 0:
            return
        rows = self.store.rows_of(sub, allocate=True)
        cl = self.store.take("cluster_idx", rows)
        cl[:, slot] = assign[has]
        self.store.put("cluster_idx", rows, cl)

    def propagate(self, cids, delta, slot_dist: Dict[int, int]):
        if not slot_dist or np.asarray(cids).size == 0:
            return
        slots = np.fromiter(slot_dist.keys(), np.int64, len(slot_dist))
        dists = np.fromiter(slot_dist.values(), np.float64, len(slot_dist))
        rows = self.store.rows_of(np.asarray(cids, np.int64), allocate=True)
        rw = self.store.take("reward", rows)
        kn = self.store.take("known", rows)
        rw[:, slots] += delta[:, None] / (dists[None, :] + 1)
        kn[:, slots] = True
        self.store.put("reward", rows, rw)
        self.store.put("known", rows, kn)

    def seed_children(self, parent_slot: int, child_slots: List[int]):
        # lazy partition reseed: only chunks holding touched clients exist,
        # and only rows with a parent reward record rewrite
        for rw, kn, cl in self.store.chunk_views(self.FIELDS):
            has = kn[:, parent_slot]
            if not has.any():
                continue
            base = rw[has, parent_slot]
            L = cl[has, parent_slot]
            for k, cs in enumerate(child_slots):
                rw[has, cs] = base + np.where(L == k, 0.1, 0.0)
                kn[has, cs] = True
                cl[has, cs] = 0

    def preferred_slot(self, c: int, slots: np.ndarray) -> Optional[int]:
        rw, kn, _ = self.gather_rows(np.asarray([c], np.int64))
        known = kn[0, slots]
        if not known.any():
            return None
        masked = np.where(known, rw[0, slots], -np.inf)
        return int(slots[int(np.argmax(masked))])

    def to_dense(self, n: Optional[int] = None):
        return tuple(self.store.to_dense(f, n) for f in self.FIELDS)
