"""The port's serving plane (``repro_torch.serve``) against the JAX
package's, in one process (mirrors tests/test_serving_plane.py).

Paged decode: the same carried-across bank gives the same greedy token
streams, with logits within 1e-4 (XLA and torch sum the matrix products in
different orders). The plane: on the scenario of tests/test_torch_round.py,
both engines route every client to the same slot and predict the same
classes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_config as jreduce
from repro.data import make_population as jmake
from repro.fl import AuxoConfig as JAuxo, AuxoEngine as JEngine, FLConfig as JFL
from repro.fl.task import MLPTask as JTask
from repro.models import build_model as jbuild
from repro.serve import (
    AdmissionBatcher as JBatcher,
    CohortDecoder as JDecoder,
    PagedKVCache as JCache,
    QueryStream as JStream,
    ServingPlane as JPlane,
    StreamConfig as JStreamConfig,
)
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_population
from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask
from repro_torch.models import build_model
from repro_torch.serve import (
    AdmissionBatcher,
    CohortDecoder,
    PagedKVCache,
    QueryStream,
    ServingPlane,
    StreamConfig,
)

# tests/test_torch_round.py: examples/quickstart.py at 120 clients / 12 rounds
POP = dict(n_clients=120, n_groups=2, group_sep=0.0, dirichlet=2.0, label_conflict=0.6, seed=0)
FL = dict(rounds=12, participants_per_round=40, eval_every=4, seed=0, use_availability=False)
AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=2, clustering_start_frac=0.05,
            partition_start_frac=0.1, min_members=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ paged decode
def _tiny(get, reduce, build):
    """tests/test_serving_plane.py's _tiny_lm: a reduced qwen3-8b (hd 16,
    qk_norm, θ = 1e6)."""
    return build(reduce(get("qwen3-8b")).replace(d_model=64, vocab=128, n_layers=2))


@pytest.fixture(scope="module")
def banks():
    """A 6-slot JAX bank (tests/test_serving_plane.py's _fake_bank) and the
    same bank carried across to the port."""
    jm = _tiny(jget, jreduce, jbuild)
    key = jax.random.key(0)
    ps = [jm.init(jax.random.fold_in(key, i)) for i in range(6)]
    jb = jax.tree.map(lambda *a: jnp.stack(a), *ps)
    tm = _tiny(get_config, reduce_config, build_model)
    assert tm.cfg.hd == 16 and tm.cfg.qk_norm and tm.cfg.rope_theta == 1e6
    return jm, jb, tm, params_from_numpy(jax.tree.map(np.asarray, jb), "cpu")


@pytest.mark.parametrize("backends", [("pallas", "kernel"), ("ref", "ref")])
def test_cohort_decoder_matches_jax(banks, backends):
    jm, jb, tm, tb = banks
    live = [0, 2, 3]
    jd = JDecoder(jm, lambda: jb, lambda: list(live), lanes=2, page_size=64, backend=backends[0])
    td = CohortDecoder(tm, lambda: tb, lambda: list(live), lanes=2, page_size=64,
                       backend=backends[1], device="cpu")
    jt, jl = jd.decode(12)
    tt, tl = td.decode(12)
    assert tt.shape == (3, 2, 12) and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    assert float(np.abs(tl - jl).max()) < 1e-4
    assert td.decode_dispatches == 12  # one fleet step per decoded position
    np.testing.assert_array_equal(td.cache.index, jd.cache.index)
    # a second call continues every lane from where it stopped
    np.testing.assert_array_equal(td.decode(3)[0], jd.decode(3)[0])


def test_paged_kv_partition_scatter_and_cohort_scaling(banks):
    _, _, tm, tb = banks
    live = [0, 1]
    dec = CohortDecoder(tm, lambda: tb, lambda: list(live), lanes=2, page_size=64,
                        backend="ref", device="cpu")
    dec.decode(8)
    bytes2 = dec.kv_nbytes
    idx_before = {s: int(dec.cache.index[i]) for i, s in enumerate(dec.cache.slots)}
    # "partition": slot 0 splits into 4, 5; slot 1 survives
    live = [1, 4, 5]
    dec.decode(4)
    # survivor kept its pages and position; children started cold
    row1 = dec.cache.slots.index(1)
    assert int(dec.cache.index[row1]) == idx_before[1] + 4
    for s in (4, 5):
        assert int(dec.cache.index[dec.cache.slots.index(s)]) == 4
    assert 0 not in dec.cache.slots  # parent's pages freed
    # resident KV bytes scale with LIVE COHORTS (pow2 rows), nothing else
    live = [0, 1, 2, 3]
    dec.sync()
    assert dec.kv_nbytes == 2 * bytes2
    # page growth doubles the page count, not the row count
    rows, pages = dec.cache.rows, dec.cache.pages
    dec.cache.ensure(dec.cache.seq + 1)
    assert dec.cache.rows == rows and dec.cache.pages == 2 * pages


def test_survivor_keeps_decoding_like_jax_across_a_partition(banks):
    jm, jb, tm, tb = banks
    live = [0, 1]
    jd = JDecoder(jm, lambda: jb, lambda: list(live), lanes=2, page_size=64, backend="ref")
    td = CohortDecoder(tm, lambda: tb, lambda: list(live), lanes=2, page_size=64,
                       backend="ref", device="cpu")
    np.testing.assert_array_equal(td.decode(5)[0], jd.decode(5)[0])
    live = [1, 4, 5]
    np.testing.assert_array_equal(td.decode(6)[0], jd.decode(6)[0])
    assert td.cache.slots == jd.cache.slots == [1, 4, 5]


def test_cohort_decoder_from_engine_wiring(banks):
    _, _, tm, tb = banks

    class _Tree:
        def leaves(self):
            return ["0.0", "0.1"]

    class _NS:
        pass

    eng = _NS()
    eng.task = _NS()
    eng.task.model = tm
    eng.device = torch.device("cpu")
    eng.pipeline = _NS()
    eng.pipeline.serve_params = tb
    eng.pipeline.bank = _NS()
    eng.pipeline.bank.slot_of = {"0": 0, "0.0": 1, "0.1": 2}
    eng.coordinator = _NS()
    eng.coordinator.tree = _Tree()

    dec = CohortDecoder.from_engine(eng, lanes=2, page_size=64, backend="ref")
    toks, _ = dec.decode(3)
    assert toks.shape == (2, 2, 3)
    assert dec.cache.slots == [1, 2]
    assert dec.device.type == "cpu"


def test_decoder_refuses_sliding_window_and_other_families():
    for arch in ("h2o-danube-3-4b", "qwen3-moe-235b-a22b", "zamba2-7b"):
        m = build_model(reduce_config(get_config(arch)))
        with pytest.raises(NotImplementedError):
            CohortDecoder(m, dict, list, device="cpu")


def test_paged_kv_cache_matches_jax():
    """sync / ensure keep the JAX cache's rows, pages, bytes, positions and
    contents (the port's layout puts lanes before layers)."""
    kw = dict(n_layers=3, lanes=2, n_kv_heads=2, head_dim=16, page_size=8)
    jc, tc = JCache(**kw), PagedKVCache(**kw, device="cpu")
    rng = np.random.default_rng(0)
    for live, extra in (([3, 5], 5), ([5, 7, 9], 12), ([9], 3), ([2, 9, 11, 12, 13], 40)):
        jc.sync(live)
        tc.sync(live)
        jc.ensure(extra)
        tc.ensure(extra)
        assert (tc.rows, tc.seq, tc.pages, tc.nbytes, tc.slots) == (
            jc.rows, jc.seq, jc.pages, jc.nbytes, jc.slots)
        np.testing.assert_array_equal(tc.index, jc.index)
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k).transpose(0, 2, 1, 3, 4, 5))
        # every row writes fresh values and advances, as a decode step does
        new = rng.standard_normal(np.asarray(jc.k).shape).astype(np.float32)
        jc.k = jnp.asarray(new)
        tc.k = torch.from_numpy(new.transpose(0, 2, 1, 3, 4, 5).copy())
        jc.index = jc.index + 1
        tc.index = tc.index + 1
    with pytest.raises(RuntimeError):
        PagedKVCache(**kw, device="cpu").ensure(1)


def test_stream_and_admission_match_jax():
    cfg = dict(n_queries=1000, rate=10_000.0, hot_frac=0.5, seed=2)
    hot, cold = np.arange(50), np.arange(50, 100)
    js, ts = JStream(JStreamConfig(**cfg), hot, cold), QueryStream(StreamConfig(**cfg), hot, cold)
    np.testing.assert_array_equal(ts.ids, js.ids)
    np.testing.assert_array_equal(ts.arrivals, js.arrivals)
    assert list(ts) == list(js)
    jbs = JBatcher(max_batch=64, max_wait=2e-3).admit(js)
    tbs = AdmissionBatcher(max_batch=64, max_wait=2e-3).admit(ts)
    assert len(tbs) == len(jbs) > 1
    for a, b in zip(tbs, jbs):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.arrivals, b.arrivals)
        assert a.t_close == b.t_close


# ------------------------------------------------------------ serving plane
@pytest.fixture(scope="module")
def engines():
    je = JEngine(JTask(dim=32, n_classes=10), jmake(**POP), JFL(**FL), JAuxo(**AUXO))
    for r in range(FL["rounds"]):
        je.step(r)
    te = AuxoEngine(
        MLPTask(dim=32, n_classes=10), make_population(**POP), FLConfig(**FL), AuxoConfig(**AUXO),
        device="cpu", init_params=jax.tree.map(np.asarray, je._init_params),
    )
    for r in range(FL["rounds"]):
        te.step(r)
    return je, te


def _pools(eng):
    ids = np.arange(POP["n_clients"], dtype=np.int64)
    hot = ids[np.asarray(eng.fp_seen[ids], bool)]
    return hot, np.setdiff1d(ids, hot)


def test_serving_plane_matches_jax(engines):
    je, te = engines
    assert te.coordinator.tree.leaves() == je.coordinator.tree.leaves()
    assert len(te.coordinator.tree.leaves()) >= 2, "the scenario must partition"
    # the snapshot is the bank at the last round boundary
    assert te.pipeline.serve_params is te.pipeline.bank.params
    hot, cold = _pools(te)
    np.testing.assert_array_equal(hot, _pools(je)[0])
    assert hot.size and cold.size
    ids = np.arange(POP["n_clients"], dtype=np.int64)
    jp, tp = JPlane(je, max_batch=64), ServingPlane(te, max_batch=64)
    slots = tp.route_slots(ids)
    np.testing.assert_array_equal(slots, jp.route_slots(ids))
    assert len(set(slots.tolist())) >= 2  # queries spread over several cohorts
    cfg = dict(n_queries=400, hot_frac=0.7, seed=3)
    pa, ba = jp.serve_stream(JStream(JStreamConfig(**cfg), hot, cold))
    d0 = te.probe_train_dispatches
    pb, bb = tp.serve_stream(QueryStream(StreamConfig(**cfg), hot, cold))
    assert len(bb) == len(ba) > 1
    np.testing.assert_array_equal(pb, pa)
    # ONE inference per admitted batch, however many cohorts it mixes;
    # cold ids were probed by route_slots above, so no new probe batch
    assert tp.infer_dispatches == tp.batches_served == len(bb)
    assert tp.queries_served == 400
    assert te.probe_train_dispatches == d0
    assert tp.route_slots(np.zeros(0, np.int64)).shape == (0,)
    assert tp.serve_batch(np.zeros(0, np.int64)).shape == (0,)


def test_probe_cache_is_invalidated_after_a_partition(engines):
    _, te = engines
    _, cold = _pools(te)
    plane = ServingPlane(te)
    te._probe_cache.clear()
    d0 = te.probe_train_dispatches
    plane.route_slots(cold[:8])
    assert te.probe_train_dispatches == d0 + 1  # all misses in ONE batch
    plane.route_slots(cold[:8])
    assert te.probe_train_dispatches == d0 + 1  # cached
    te.coordinator.partitions.append(te.coordinator.partitions[0])
    try:
        plane.route_slots(cold[:8])
        assert te.probe_train_dispatches == d0 + 2  # invalidated
    finally:
        te.coordinator.partitions.pop()
