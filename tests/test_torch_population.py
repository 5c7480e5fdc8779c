"""§⑥/⑦ population plane in the port: the chunked PopulationStore, streaming
availability, churn and the procedural data plane (verbatim numpy copies
of the JAX package's, held draw for draw and byte for byte against them),
and the store-backed engine against the port's dense engine (bit for bit)
and against the JAX package's store-backed engine (one process: child
clusterers are seeded from ``hash(child_id)``)."""

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest

from repro.data import AvailabilityTrace as JTrace
from repro.data import ProceduralDataPlane as JPlane
from repro.data import make_population as jmake
from repro.scale import ChunkedAffinityTable as JChunked
from repro.scale import ChurnStream as JChurn
from repro.scale import StreamingAvailability as JStreaming
from repro.scale import make_client_store as jmake_store
from repro_torch.data import AvailabilityTrace, MaterializedDataPlane, ProceduralDataPlane
from repro_torch.data import make_population
from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask
from repro_torch.fl.pipeline import AffinityTable
from repro_torch.scale import (
    ChunkedAffinityTable,
    ChurnStream,
    ClientField,
    StreamingAvailability,
    make_client_store,
)
from torch_engine_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    one_torch_thread,
    MODES_AUXO, MODES_FL, MODES_POP, RUN_AUXO, RUN_FL, RUN_POP,
    assert_bit_equal, assert_params_close, assert_same_discrete, init_of, jax_engine,
    port_engine,
)

N_CLIENTS = 64
CAPACITY = 8


# --------------------------------------------------------------- the store
def _tables():
    dense = AffinityTable(N_CLIENTS, CAPACITY)
    chunked = ChunkedAffinityTable(
        make_client_store(N_CLIENTS, d_sketch=4, capacity=CAPACITY, chunk_rows=16)
    )
    ref = JChunked(jmake_store(N_CLIENTS, d_sketch=4, capacity=CAPACITY, chunk_rows=16))
    return dense, chunked, ref


def _assert_equal(*tables):
    first = tables[0]
    want = (first.reward, first.known, first.cluster_idx)
    for t in tables[1:]:
        for a, b in zip(want, t.to_dense(N_CLIENTS)):
            np.testing.assert_array_equal(a, b)


def _apply_random_op(rng, tables):
    op = rng.integers(6)
    ids = np.unique(rng.integers(0, N_CLIENTS, size=rng.integers(1, 12)))
    slot = int(rng.integers(CAPACITY))
    if op == 0:
        delta = rng.normal(size=ids.size).astype(np.float32)
        for t in tables:
            t.feedback(ids, slot, delta, 0.2)
    elif op == 1:
        assign = rng.integers(-1, 3, size=ids.size).astype(np.int32)
        for t in tables:
            t.set_cluster(ids, slot, assign)
    elif op == 2:
        delta = rng.normal(size=ids.size).astype(np.float32)
        slots = rng.permutation(CAPACITY)[: rng.integers(1, 4)]
        slot_dist = {int(s): int(rng.integers(1, 4)) for s in slots}
        for t in tables:
            t.propagate(ids, delta, slot_dist)
    elif op == 3:
        for t in tables:
            t.wipe(ids)
    elif op == 4:
        children = [int(c) for c in rng.permutation(CAPACITY)[:2]]
        for t in tables:
            t.seed_children(slot, children)
    else:
        got = [t.gather_rows(ids) for t in tables]
        for g in got[1:]:
            for a, b in zip(got[0], g):
                np.testing.assert_array_equal(a, b)
        rw, kn, cl = got[0]
        rw = rw + rng.normal(size=rw.shape).astype(np.float32)
        kn = kn | (rng.random(kn.shape) < 0.3)
        for t in tables:
            t.scatter_rows(ids, rw, kn, cl)


def test_gather_scatter_roundtrip_randomized():
    """Random op sequences leave the dense table, the port's chunked table
    and the reference's chunked table bit-identical; reads of never-touched
    ids come back as defaults without allocating."""
    rng = np.random.default_rng(0)
    dense, chunked, ref = _tables()
    rw, kn, cl = chunked.gather_rows(np.arange(N_CLIENTS))
    assert chunked.store.n_rows == 0  # pure reads never materialize
    np.testing.assert_array_equal(rw, np.zeros((N_CLIENTS, CAPACITY), np.float32))
    np.testing.assert_array_equal(cl, np.full((N_CLIENTS, CAPACITY), -1, np.int32))
    for _ in range(200):
        _apply_random_op(rng, (dense, chunked, ref))
    _assert_equal(dense, chunked, ref)
    assert 0 < chunked.store.n_rows <= N_CLIENTS
    assert chunked.store.n_rows == ref.store.n_rows
    ids = np.arange(0, N_CLIENTS, 3)
    slots = np.array([0, 3, 5])
    for a, b in zip(dense.match_view(ids, slots), chunked.match_view(ids, slots)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dense.known_at(ids, 2), chunked.known_at(ids, 2))
    for c in ids[:5]:
        assert dense.preferred_slot(int(c), slots) == chunked.preferred_slot(int(c), slots)
        assert dense.cluster_at(int(c), 1) == chunked.cluster_at(int(c), 1)


def test_store_ops_property():
    """Property form of the round trip: arbitrary interleavings over
    arbitrary id sets keep the three backings bit-identical."""
    pytest.importorskip("hypothesis")  # test extra; not in every image
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 2**31 - 1), st.integers(1, 40))
    def run(seed, n_ops):
        rng = np.random.default_rng(seed)
        tables = _tables()
        for _ in range(n_ops):
            _apply_random_op(rng, tables)
        _assert_equal(*tables)

    run()


def test_client_field_numpy_semantics():
    """The engine-facing view: fancy-index gather/scatter, augmented
    assignment, scalar ids — all matching plain numpy array behavior."""
    store = make_client_store(1000, d_sketch=4, capacity=3)
    fp = ClientField(store, "fingerprint")
    ns = ClientField(store, "neg_streak")
    ids = np.array([5, 900, 17])
    fp[ids] = np.arange(12, dtype=np.float32).reshape(3, 4)
    fp[ids[:2]] *= 0.5  # gather → op → scatter
    np.testing.assert_array_equal(fp[900], np.array([2, 2.5, 3, 3.5], np.float32))
    np.testing.assert_array_equal(fp[ids[2]], np.array([8, 9, 10, 11], np.float32))
    ns[ids] = 0
    ns[ids[1:]] += 1
    assert ns[900] == 1 and ns[5] == 0 and ns[17] == 1
    fp[np.zeros(0, np.int64)] *= 0.9  # empty-id edge is a no-op
    assert (ns[np.array([0, 1, 2, 3, 4, 6])] == 0).all()  # defaults
    fp[3] = 7.0  # scalar id broadcast
    np.testing.assert_array_equal(fp[3], np.full(4, 7.0, np.float32))
    assert store.n_rows == 4  # only the touched ids (5, 900, 17, 3) cost rows


def test_rearrival_is_cold_even_after_late_feedback():
    """§⑤ overlap can deliver feedback for a round that was in flight when
    a client departed; the cold-start contract holds at ARRIVAL time."""
    store = make_client_store(100, d_sketch=4, capacity=3)
    store.scatter("fingerprint", np.array([7]), 1.0)
    store.scatter("fp_seen", np.array([7]), True)
    store.depart(np.array([7]))
    store.scatter("fingerprint", np.array([7]), 2.0)  # late in-flight feedback
    store.scatter("fp_seen", np.array([7]), True)
    store.arrive(np.array([7]))
    assert store.alive(np.array([7]))[0]
    assert not store.gather("fp_seen", np.array([7]))[0]
    assert (store.gather("fingerprint", np.array([7])) == 0).all()


# ------------------------------------------------- availability and churn
def test_streaming_compat_is_dense_trace_and_the_reference():
    tr = AvailabilityTrace(n_clients=500, seed=3)
    sa = StreamingAvailability(n_clients=500, seed=3, mode="compat")
    ja = JStreaming(n_clients=500, seed=3, mode="compat")
    for r in (0, 7, 90):
        a = tr.available(r, np.random.default_rng(11))
        np.testing.assert_array_equal(a, sa.available(r, np.random.default_rng(11)))
        np.testing.assert_array_equal(a, ja.available(r, np.random.default_rng(11)))
        np.testing.assert_array_equal(a, JTrace(n_clients=500, seed=3).available(r, np.random.default_rng(11)))
        for k in (None, 10):
            ids, n = sa.sample(r, k)
            jids, jn = ja.sample(r, k)
            np.testing.assert_array_equal(ids, jids)
            assert n == jn


def test_per_round_substream_is_call_order_independent():
    tr = AvailabilityTrace(n_clients=400, seed=1)
    fwd = [tr.available(r) for r in range(5)]
    rev = [tr.available(r) for r in reversed(range(5))]
    for r in range(5):
        np.testing.assert_array_equal(fwd[r], rev[4 - r])


def test_chunked_sampler_rate_budget_and_reference_draws():
    sa = StreamingAvailability(n_clients=200_000, seed=0, mode="chunked", base_rate=0.05)
    ja = JStreaming(n_clients=200_000, seed=0, mode="chunked", base_rate=0.05)
    for r in (0, 3, 17):
        for k, rng in ((500, None), (None, 5), (100, 9)):
            ids, tot = sa.sample(r, k, None if rng is None else np.random.default_rng(rng))
            jids, jtot = ja.sample(r, k, None if rng is None else np.random.default_rng(rng))
            np.testing.assert_array_equal(ids, jids)
            assert tot == jtot
    ids1, tot1 = sa.sample(3, 500)
    ids2, tot2 = sa.sample(3, 500)
    np.testing.assert_array_equal(ids1, ids2)
    assert tot1 == tot2
    tots = [sa.sample(r, 100)[1] for r in range(20)]
    rate = np.mean(tots) / 200_000
    assert 0.02 < rate < 0.09
    ids, tot = sa.sample(0, 500)
    assert ids.size <= 500 < tot
    assert ids.size and np.all((0 <= ids) & (ids < 200_000))
    assert np.array_equal(ids, np.unique(ids))
    all_ids = sa.available(0)
    assert abs(all_ids.size - tot) / tot < 0.15


def test_churn_stream_conserves_population_and_matches_reference():
    cs = ChurnStream(n_clients=1000, depart_rate=0.05, return_rate=0.3, seed=2)
    js = JChurn(n_clients=1000, depart_rate=0.05, return_rate=0.3, seed=2)
    seen_away = set()
    for r in range(30):
        dep, arr = cs.step(r)
        jdep, jarr = js.step(r)
        np.testing.assert_array_equal(dep, jdep)
        np.testing.assert_array_equal(arr, jarr)
        assert np.intersect1d(dep, arr).size == 0
        seen_away.difference_update(arr.tolist())
        assert not seen_away.intersection(dep.tolist())  # no double departure
        seen_away.update(dep.tolist())
        assert set(cs.away.tolist()) == seen_away
    assert 0 < cs.away.size < 1000


# ------------------------------------------------------- procedural plane
PLANE_KW = dict(n_groups=4, group_sep=0.0, dirichlet=3.0, label_conflict=1.0, seed=7)


@pytest.mark.parametrize("n_clients", [300, 1_000_000])
def test_procedural_plane_byte_equal_to_reference(n_clients):
    """Same spec, same ids: sizes, shards, training and probe draws, eval
    sets and resident bytes are the reference's, byte for byte."""
    tp = ProceduralDataPlane(n_clients=n_clients, **PLANE_KW)
    jp = JPlane(n_clients=n_clients, **PLANE_KW)
    ids = np.array([0, 1, 5, 299, n_clients - 1, n_clients // 3], np.int64)
    np.testing.assert_array_equal(tp.client_sizes(ids), jp.client_sizes(ids))
    np.testing.assert_array_equal(tp.client_groups(ids), jp.client_groups(ids))
    for c in ids:
        for a, b in zip(tp._shard(int(c)), jp._shard(int(c))):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(tp.sample_batches(ids, 8, 3, np.random.default_rng(4)),
                    jp.sample_batches(ids, 8, 3, np.random.default_rng(4))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(tp.probe_batches(ids, 8, 2), jp.probe_batches(ids, 8, 2)):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(tp.eval_batches(), jp.eval_batches()):
        assert a.tobytes() == b.tobytes()
    assert tp.data_nbytes == jp.data_nbytes
    assert tp.plane_spec() == jp.plane_spec()


def test_procedural_determinism_across_instances_and_orders():
    """Same id + same spec ⇒ same shard/batch, regardless of which other
    ids were touched first, LRU evictions, or which instance serves it."""
    kw = dict(n_clients=100_000, n_groups=4, seed=9)
    p1 = ProceduralDataPlane(**kw)
    p2 = ProceduralDataPlane(**kw, shard_cache=2)  # tiny LRU: evict + regen
    ids = np.array([3, 77_123, 5, 99_999], np.int64)
    for c in [50, 60, 70] + ids[::-1].tolist():
        p2._shard(int(c))
    np.testing.assert_array_equal(p1.client_sizes(ids), p2.client_sizes(ids))
    for c in ids:
        x1, y1 = p1._shard(int(c))
        x2, y2 = p2._shard(int(c))
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
    bx1, by1 = p1.sample_batches(ids, 8, 3, np.random.default_rng(4))
    bx2, by2 = p2.sample_batches(ids, 8, 3, np.random.default_rng(4))
    np.testing.assert_array_equal(bx1, bx2)
    np.testing.assert_array_equal(by1, by2)
    px1, py1 = p1.probe_batches(ids, 8, 2)
    px2, py2 = p2.probe_batches(ids, 8, 2)
    np.testing.assert_array_equal(px1, px2)
    np.testing.assert_array_equal(py1, py2)
    np.testing.assert_array_equal(p1.eval_batches()[0], p2.eval_batches()[0])
    p1.invalidate(ids[:2])
    x1b, _ = p1._shard(int(ids[0]))
    np.testing.assert_array_equal(x1b, p2._shard(int(ids[0]))[0])


def test_procedural_resident_bytes_independent_of_n():
    small = ProceduralDataPlane(n_clients=10_000, seed=1, shard_cache=64)
    big = ProceduralDataPlane(n_clients=10_000_000, seed=1, shard_cache=64)
    rng = np.random.default_rng(0)
    for p in (small, big):
        ids = rng.integers(0, p.n_clients, 200)
        p.sample_batches(ids, 4, 2, np.random.default_rng(1))
        p.eval_batches()
    assert big.data_nbytes < 2 * small.data_nbytes
    assert len(big._shards) <= 64  # LRU bound holds


def test_size_cache_hits_and_churn_invalidation():
    calls = []

    class Counting(ProceduralDataPlane):
        def _compute_sizes(self, ids):
            calls.append(ids.copy())
            return super()._compute_sizes(ids)

    p = Counting(n_clients=1000, seed=3)
    ids = np.array([5, 9, 5, 700])
    s1 = p.client_sizes(ids)
    assert len(calls) == 1 and calls[0].size == 3  # unique misses only
    s2 = p.client_sizes(ids)
    np.testing.assert_array_equal(s1, s2)
    assert len(calls) == 1  # pure cache hit: no recompute
    p.invalidate(np.array([9]))
    p.client_sizes(ids)
    assert len(calls) == 2 and calls[1].tolist() == [9]  # only the churned id
    np.testing.assert_array_equal(p.client_sizes(ids), s1)


def test_procedural_matches_materialized_group_structure():
    """Both planes built from one spec share the group-level generative
    structure bit for bit (same seed header stream), and their per-group
    label priors agree statistically (hash stream vs sequential stream)."""
    kw = dict(MODES_POP, n_clients=240)
    pop = make_population(**kw)
    mat = MaterializedDataPlane(pop)
    proc = ProceduralDataPlane(**kw)
    ids = np.arange(240, dtype=np.int64)
    np.testing.assert_array_equal(proc.client_groups(ids), mat.client_groups(ids))
    _, ty_m = mat.eval_batches()
    _, ty_p = proc.eval_batches()
    for g in range(4):
        hm = np.bincount(ty_m[g], minlength=10) / ty_m[g].size
        hp = np.bincount(ty_p[g], minlength=10) / ty_p[g].size
        assert 0.5 * np.abs(hm - hp).sum() < 0.08, (g, hm, hp)  # TV distance
    rng = np.random.default_rng(11)
    bx_m, by_m = mat.sample_batches(ids, 16, 4, rng)
    bx_p, by_p = proc.sample_batches(ids, 16, 4, np.random.default_rng(11))
    groups = proc.client_groups(ids)
    for g in range(4):
        hm = np.bincount(by_m[groups == g].ravel(), minlength=10)
        hp = np.bincount(by_p[groups == g].ravel(), minlength=10)
        hm = hm / hm.sum()
        hp = hp / hp.sum()
        assert 0.5 * np.abs(hm - hp).sum() < 0.12, (g, hm, hp)
        mu_m = bx_m[groups == g].reshape(-1, proc.dim).mean(0)
        mu_p = bx_p[groups == g].reshape(-1, proc.dim).mean(0)
        assert np.linalg.norm(mu_m - mu_p) < 0.35 * max(np.linalg.norm(mu_m), 1.0), g
    sm = np.log(mat.client_sizes(ids))
    sp = np.log(proc.client_sizes(ids))
    assert abs(sm.mean() - sp.mean()) < 0.25
    assert abs(sm.std() - sp.std()) < 0.25


# ------------------------------------------------ the store-backed engine
def _modes_pair(rounds, **fl_kw):
    pop = make_population(**MODES_POP)
    fl = dict(MODES_FL, rounds=rounds, eval_every=rounds - 1, **fl_kw)
    return pop, port_engine(pop, fl, MODES_AUXO), port_engine(pop, fl, MODES_AUXO, population_store=True)


def test_population_store_bit_equal_sync():
    """A full small-N run through the chunked PopulationStore is bit for bit
    the dense-table run, partitions and evaluation included."""
    pop, eng_a, eng_b = _modes_pair(30)
    hist_a = eng_a.run()
    hist_b = eng_b.run()
    assert len(eng_a.coordinator.partitions) >= 1
    assert_bit_equal(eng_a, eng_b, pop.n_clients)
    np.testing.assert_array_equal(hist_a[-1]["per_client"], hist_b[-1]["per_client"])
    assert eng_b.store.n_rows <= pop.n_clients


def test_population_store_bit_equal_overlap():
    """The same under the §⑤ overlap (stale plans and partition flushes go
    through the store views too)."""
    pop, eng_a, eng_b = _modes_pair(30, round_overlap=1)
    for r in range(30):
        eng_a.step(r)
        eng_b.step(r)
    eng_a.pipeline.flush()
    eng_b.pipeline.flush()
    assert eng_a.pipeline.flushes >= 1
    assert eng_a.pipeline.flushes == eng_b.pipeline.flushes
    assert_bit_equal(eng_a, eng_b, pop.n_clients)


def test_population_store_bit_equal_with_availability():
    """use_availability=True: compat StreamingAvailability consumes the
    engine RNG exactly like the dense AvailabilityTrace."""
    pop, eng_a, eng_b = _modes_pair(10, use_availability=True)
    hist_a = eng_a.run()
    hist_b = eng_b.run()
    assert_bit_equal(eng_a, eng_b, pop.n_clients)
    np.testing.assert_array_equal(hist_a[-1]["per_client"], hist_b[-1]["per_client"])


def test_procedural_engine_dense_equals_population_store():
    """The equivalence holds with the streaming data plane too."""
    kw = dict(n_clients=300, **{k: v for k, v in MODES_POP.items() if k != "n_clients"})
    fl = dict(MODES_FL, rounds=24, eval_every=23)
    task = MLPTask(dim=32, n_classes=10)
    eng_a = AuxoEngine(task, ProceduralDataPlane(**kw), FLConfig(**fl), AuxoConfig(**MODES_AUXO),
                       device="cpu")
    eng_b = AuxoEngine(task, ProceduralDataPlane(**kw), FLConfig(**fl, population_store=True),
                       AuxoConfig(**MODES_AUXO), device="cpu")
    hist_a = eng_a.run()
    hist_b = eng_b.run()
    assert_bit_equal(eng_a, eng_b, 300)
    np.testing.assert_array_equal(hist_a[-1]["per_client"], hist_b[-1]["per_client"])


def test_churn_departure_and_probe_rearrival():
    """A departed client's soft state is wiped; its re-arrival is a cold
    start that routes through the probe-fingerprint path at serve time."""
    pop = make_population(**MODES_POP)
    eng = port_engine(pop, dict(MODES_FL, rounds=14, eval_every=13), MODES_AUXO,
                      population_store=True)
    for r in range(14):
        eng.step(r)
    eng.pipeline.flush()
    trained = np.flatnonzero(eng.store.to_dense("fp_seen", pop.n_clients))
    assert trained.size
    c = int(trained[0])
    eng.apply_churn(departures=[c])
    assert not eng.fp_seen[c]
    assert not eng.store.alive(np.array([c]))[0]
    rw, kn, _ = eng.pipeline.table.gather_rows(np.array([c]))
    assert not kn.any() and not rw.any()
    plan = eng.pipeline.plan_round(14)
    assert plan is None or c not in plan.client_rows[plan.real]
    eng.apply_churn(arrivals=[c])
    assert eng.store.alive(np.array([c]))[0]
    assert eng.store.n_departed == 0
    before = eng.probe_train_dispatches
    leaf = eng.client_cohort(c)
    assert leaf in eng.coordinator.tree.nodes
    assert eng.probe_train_dispatches == before + 1  # a probe: cold start
    assert c in eng._probe_cache  # cached in the store's probe rows
    eng.client_cohort(c)
    assert eng.probe_train_dispatches == before + 1  # served from the cache


def test_churn_needs_the_population_store():
    eng = port_engine(make_population(**RUN_POP), RUN_FL, RUN_AUXO)
    with pytest.raises(ValueError, match="population_store"):
        eng.apply_churn(departures=[1])


def test_warm_rearrival_matching_ab():
    """A/B of FLConfig.warm_rearrivals: cold re-arrivals re-explore at
    random; warm ones seed their first check-in from the probe
    fingerprint's nearest-identity leaf, and the one-shot marker clears
    once consumed by a kept row."""
    pop = make_population(**MODES_POP)
    agree = {}
    for warm in (False, True):
        eng = port_engine(pop, MODES_FL, MODES_AUXO, population_store=True, warm_rearrivals=warm)
        for r in range(30):
            eng.step(r)
        eng.pipeline.flush()
        leaves = eng.coordinator.tree.leaves()
        assert len(leaves) >= 2 and len(eng.coordinator.identity) >= 2
        trained = np.flatnonzero(eng.store.to_dense("fp_seen", pop.n_clients))[:40]
        eng.apply_churn(departures=trained)
        eng.apply_churn(arrivals=trained)
        np.testing.assert_array_equal(
            eng.store.gather("rearrived", trained), np.ones(trained.size, bool)
        )
        slots = np.array([eng.pipeline.bank.slot_of[l] for l in leaves])
        want, _ = eng.pipeline._match_vectorized(30, trained, leaves, slots)
        best, _m, il = eng.coordinator.match_many(eng._probe_fingerprints(trained))
        expected = np.array([leaves.index(l) for l in il])[best]
        agree[warm] = float(np.mean(want == expected))
        assert eng.store.gather("rearrived", trained).all()  # matching keeps the marker
        eng.step(30)
        eng.pipeline.flush()
        remaining = eng.store.gather("rearrived", trained)
        if warm:
            assert remaining.sum() < trained.size  # kept rows consumed seeds
        else:
            assert remaining.all()  # the cold policy never touches the marker
    assert agree[True] == 1.0
    assert agree[False] < 0.8


def test_engine_runs_with_chunked_availability_and_churn():
    """The dynamic-population mode end to end: chunked sampling and an
    attached churn stream; rounds train, histories stay well-formed."""
    pop = make_population(**MODES_POP)
    eng = port_engine(pop, dict(MODES_FL, rounds=8, eval_every=7), MODES_AUXO,
                      use_availability=True, population_store=True, availability_mode="chunked")
    eng.trace.base_rate = 0.5  # the tiny population is one chunk
    eng.churn = ChurnStream(pop.n_clients, depart_rate=0.02, return_rate=0.5, seed=1)
    hist = eng.run()
    assert eng.pipeline.exec_dispatches >= 1
    assert 0.0 <= hist[-1]["acc_mean"] <= 1.0
    assert eng.store.n_rows <= pop.n_clients + 1


# ----------------------------------------------- against the JAX package
@pytest.mark.parametrize("overlap", [0, 1])
def test_store_engine_with_churn_matches_reference(overlap):
    """The store-backed engine, chunked availability and a churn stream, in
    both packages from the same initial weights (sync and overlapped):
    same partitions, slots, assignments, counts and per-client soft state;
    params within the whole-run tolerance."""
    kw = dict(population_store=True, use_availability=True, availability_mode="chunked",
              round_overlap=overlap)
    je = jax_engine(jmake(**RUN_POP), RUN_FL, RUN_AUXO, **kw)
    te = port_engine(make_population(**RUN_POP), RUN_FL, RUN_AUXO, init=init_of(je), **kw)
    for eng, churn in ((je, JChurn), (te, ChurnStream)):
        eng.trace.base_rate = 0.5  # the tiny population is one chunk
        eng.churn = churn(RUN_POP["n_clients"], depart_rate=0.02, return_rate=0.5, seed=1)
    je.run()
    te.run()
    assert je.coordinator.partitions, "the scenario must partition"
    assert_same_discrete(je, te, RUN_POP["n_clients"])
    assert_params_close(je, te)
    np.testing.assert_array_equal(te.churn.away, je.churn.away)
    assert te.store.n_rows == je.store.n_rows and te.store.n_departed == je.store.n_departed
    for f in ("fp_seen", "neg_streak", "rearrived"):
        np.testing.assert_array_equal(te.store.to_dense(f, 120), je.store.to_dense(f, 120), err_msg=f)
    np.testing.assert_allclose(te.store.to_dense("fingerprint", 120),
                               je.store.to_dense("fingerprint", 120), rtol=1e-4, atol=1e-5)


def test_procedural_store_engine_matches_reference():
    """The full-width configuration's shape (ProceduralDataPlane, store,
    chunked availability, churn), cut to 3,000 clients and 6 rounds."""
    plane_kw = dict(n_clients=3000, **PLANE_KW)
    fl = dict(rounds=6, participants_per_round=40, eval_every=10**9, seed=7)
    auxo = dict(d_sketch=64, cluster_k=2, max_cohorts=4, clustering_start_frac=0.0,
                partition_start_frac=0.3, partition_end_frac=0.9, min_members=10)
    kw = dict(population_store=True, availability_mode="chunked", use_availability=True)
    je = jax_engine(JPlane(**plane_kw), fl, auxo, **kw)
    te = port_engine(ProceduralDataPlane(**plane_kw), fl, auxo, init=init_of(je), **kw)
    for eng, churn in ((je, JChurn), (te, ChurnStream)):
        eng.churn = churn(3000, depart_rate=1e-2, return_rate=0.1, seed=7)
        for r in range(fl["rounds"]):
            eng.step(r)
        eng.pipeline.flush()
    assert te.pipeline.exec_dispatches == je.pipeline.exec_dispatches >= fl["rounds"]
    assert_same_discrete(je, te, 3000)
    assert_params_close(je, te)
    assert te.data.data_nbytes == je.data.data_nbytes
