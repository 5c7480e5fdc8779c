"""§⑤ round overlap in the port (``FLConfig.round_overlap = 1``), and the
host control plane's numpy twins, against the port's own synchronous
schedule and against the JAX package (one process: child clusterers are
seeded from ``hash(child_id)``).

The overlapped schedule is a pure reordering: it equals a SYNCHRONOUS run
fed the same one-round-stale plans bit for bit (tests/test_round_overlap.py
holds the JAX package to the same). On the CPU every copy is synchronous;
the card's asynchronous copies and events are held the same way by
``chip_smoke.py`` phase 11b.
"""
import dataclasses

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from repro.core.clustering import ClusterState as JClusterState
from repro.core.clustering import _cosine_np as j_cosine_np
from repro.core.clustering import assign_and_update_np as j_assign_np
from repro.core.selection import instant_reward_np as j_reward_np
from repro.data import make_population as jmake
from repro_torch.convert import cluster_state_from_numpy
from repro_torch.core.clustering import (
    OnlineClustering, _cosine_np, assign_and_update_np, host_state,
)
from repro_torch.core.coordinator import CohortCoordinator, CohortStats
from repro_torch.core.selection import instant_reward_np
from repro_torch.data import make_population
from repro_torch.fl.pipeline import ExecResult
from torch_engine_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    one_torch_thread,
    MODES_AUXO, MODES_FL, MODES_POP, RUN_AUXO, RUN_FL, RUN_POP,
    assert_bit_equal, assert_params_close, assert_same_discrete, init_of, jax_engine,
    port_engine, run_stale_sync,
)


# ------------------------------------------------------------- the twins
def _random_state(rng, k, d):
    c = rng.normal(size=(k, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return dict(
        centroids=c,
        counts=rng.integers(0, 50, k).astype(np.float32),
        round_counts=rng.random(k).astype(np.float32) * 10,
        dispersion=np.float32(rng.random()),
        margin=np.float32(rng.random() * 0.5),
        cluster_dispersion=rng.random(k).astype(np.float32),
        initialized=np.bool_(True),
        round=np.int32(rng.integers(1, 20)),
    )


@pytest.mark.parametrize("P,k,d", [(8, 2, 64), (32, 3, 16), (64, 2, 128), (5, 4, 7)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_twins_bit_equal_to_reference(seed, P, k, d):
    """_cosine_np, assign_and_update_np and instant_reward_np: the port's
    numpy twins are the reference's, bit for bit (masked rows included)."""
    rng = np.random.default_rng(seed * 100 + P)
    x = rng.normal(size=(P, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    mask = (rng.random(P) < 0.8).astype(np.float32)
    mask[0] = 1.0
    np.testing.assert_array_equal(_cosine_np(x, c), j_cosine_np(x, c))
    np.testing.assert_array_equal(instant_reward_np(x, mask)[0], j_reward_np(x, mask)[0])
    np.testing.assert_array_equal(instant_reward_np(x, mask)[1], j_reward_np(x, mask)[1])
    fields = _random_state(rng, k, d)
    js, ja, jsims = j_assign_np(JClusterState(**fields), x, mask, 0.3)
    # the port takes a device state as well as a host one
    for st in (host_state(cluster_state_from_numpy(**fields, device="cpu")),
               cluster_state_from_numpy(**fields, device="cpu")):
        ts, ta, tsims = assign_and_update_np(st, x, mask, 0.3)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tsims, jsims)
        for f in dataclasses.fields(JClusterState):
            np.testing.assert_array_equal(
                np.asarray(getattr(ts, f.name)), np.asarray(getattr(js, f.name)), err_msg=f.name
            )
            assert isinstance(getattr(ts, f.name), np.ndarray) or np.isscalar(getattr(ts, f.name))


def test_host_feedback_backend_keeps_numpy_states():
    """feedback_all(backend="host"): numpy inputs, the bootstrap on the
    device backend's k-means, then numpy states and twins; the same
    assignments and rewards as the device backend on the same inputs."""
    rng = np.random.default_rng(3)
    C, P, d = 2, 16, 8
    sk = rng.normal(size=(C, P, d)).astype(np.float32)
    m = np.ones((C, P), np.float32)
    m[1, 12:] = 0
    ids = [list(range(P)), list(range(100, 112))]
    out = {}
    for backend in ("host", "device"):
        co = CohortCoordinator(d_sketch=d, seed=0, clustering_start_frac=0.0, device="cpu")
        children = co.tree.partition("0", 2)
        for i, ch in enumerate(children):
            co.clusterers[ch] = OnlineClustering(2, d, seed=i + 1, device="cpu")
            co.stats[ch] = CohortStats()
        if backend == "host":
            co.use_host_states()
        rounds = []
        for r in range(3):
            x = sk + 0.1 * r
            args = (x, m) if backend == "host" else (torch.from_numpy(x), torch.from_numpy(m))
            res = co.feedback_all(children, ids, *args, r, 100, backend=backend)
            rounds.append([(fb.assign.tolist(), fb.delta) for fb in res])
        out[backend] = rounds
        if backend == "host":
            for cl in co.clusterers.values():
                assert isinstance(cl.state.centroids, np.ndarray)
    for h, dv in zip(out["host"], out["device"]):
        for (ah, dh), (ad, dd) in zip(h, dv):
            assert ah == ad
            np.testing.assert_allclose(dh, dd, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- the port alone
@pytest.fixture(scope="module")
def overlap_pair():
    pop = make_population(**MODES_POP)
    eng_a = port_engine(pop, MODES_FL, MODES_AUXO, round_overlap=1)
    for r in range(MODES_FL["rounds"]):
        eng_a.step(r)
    eng_a.pipeline.flush()
    eng_b = run_stale_sync(port_engine(pop, MODES_FL, MODES_AUXO), MODES_FL["rounds"])
    return pop, eng_a, eng_b


def test_overlap_matches_stale_sync_bit_for_bit(overlap_pair):
    pop, eng_a, eng_b = overlap_pair
    assert len(eng_a.coordinator.partitions) >= 1, "the scenario must partition"
    assert_bit_equal(eng_a, eng_b, pop.n_clients)
    # one fused dispatch per round; every partition flushed the pipeline
    assert eng_a.pipeline.exec_dispatches == MODES_FL["rounds"]
    assert eng_a.pipeline.flushes >= 1


def test_partition_mid_pipeline_flush_drains_and_refills():
    pop = make_population(**MODES_POP)
    eng = port_engine(pop, MODES_FL, MODES_AUXO, round_overlap=1)
    p = eng.pipeline
    seen_flush = 0
    for r in range(MODES_FL["rounds"]):
        before = p.bank.params
        eng.step(r)
        if p.flushes > seen_flush:
            seen_flush = p.flushes
            # drained: nothing in flight, the served bank is the live one
            assert p._inflight is None
            assert p.serve_params is p.bank.params
        elif r > 0:
            assert p._inflight is not None  # steady state keeps depth 2
            # round r in flight: serving reads the bank of boundary r-1
            assert p.serve_params is before and p.serve_params is not p.bank.params
        assert p._staged is not None and p._staged[0] == r + 1
        assert p._staged_host is not None and p._staged_host[0].shape[0] == p.width
    assert seen_flush >= 1
    p.flush()
    assert p._inflight is None and p.serve_params is p.bank.params
    leaves = eng.coordinator.tree.leaves()
    for leaf in leaves:
        assert leaf in p.bank.slot_of
    for ev in eng.coordinator.partitions:
        assert ev.parent not in leaves


def test_spawn_children_leaves_a_held_snapshot_untouched():
    pop = make_population(**RUN_POP)
    eng = port_engine(pop, RUN_FL, RUN_AUXO)
    for r in range(3):
        eng.step(r)
    bank = eng.pipeline.bank
    snap = bank.params
    copy = {k: v.clone() for k, v in snap.items()}
    slots = bank.spawn_children("0", ["0.0", "0.1"])
    for k in snap:
        assert torch.equal(snap[k], copy[k])  # the snapshot did not move
        assert bank.params[k] is not snap[k]
        for s in slots:
            assert torch.equal(bank.params[k][s], snap[k][0])


def test_flush_is_noop_on_sync_engine():
    pop = make_population(**MODES_POP)
    eng = port_engine(pop, dict(MODES_FL, rounds=4), MODES_AUXO)
    for r in range(4):
        eng.step(r)
        assert eng.pipeline._inflight is None and eng.pipeline._staged is None
    d = eng.pipeline.exec_dispatches
    params = eng.pipeline.bank.params
    eng.pipeline.flush()
    assert eng.pipeline.exec_dispatches == d
    assert eng.pipeline.bank.params is params


def test_overlap_requires_batched_mode():
    pop = make_population(**MODES_POP)
    with pytest.raises(ValueError, match="batched"):
        port_engine(pop, MODES_FL, MODES_AUXO, round_overlap=1, execution="sequential")
    with pytest.raises(ValueError, match="depth-2"):
        port_engine(pop, MODES_FL, MODES_AUXO, round_overlap=2)


def test_exec_result_of_host_tensors_is_read_at_once():
    sk, loss = torch.arange(6.0).reshape(3, 2), torch.ones(3)
    res = ExecResult.fetch(sk, loss, lazy=True)  # CPU tensors: no event
    assert res._ready is None
    np.testing.assert_array_equal(res.sketches, sk.numpy())
    np.testing.assert_array_equal(res.losses, loss.numpy())


# ----------------------------------------------- against the JAX package
def test_overlap_matches_reference_overlap():
    """The whole run with round_overlap=1 in both packages, from the same
    initial weights: same partitions, slots, assignments and counts; params
    within the whole-run tolerance."""
    je = jax_engine(jmake(**RUN_POP), RUN_FL, RUN_AUXO, round_overlap=1)
    je.run()
    te = port_engine(make_population(**RUN_POP), RUN_FL, RUN_AUXO, init=init_of(je), round_overlap=1)
    te.run()
    assert je.coordinator.partitions, "the scenario must partition"
    assert te.pipeline.flushes == je.pipeline.flushes
    assert_same_discrete(je, te, RUN_POP["n_clients"])
    assert_params_close(je, te)
    assert te.serving_cohorts() == je.serving_cohorts()


def test_overlap_discrete_outcomes_match_reference_on_two_partitions(overlap_pair):
    """The 30-round scenario: two partitions and two flushes, the same in
    both packages (params are held on the whole-run scenario above, see
    torch_engine_cases)."""
    pop, eng_a, _ = overlap_pair
    je = jax_engine(jmake(**MODES_POP), MODES_FL, MODES_AUXO, round_overlap=1)
    te = port_engine(pop, MODES_FL, MODES_AUXO, init=init_of(je), round_overlap=1)
    for r in range(MODES_FL["rounds"]):
        je.step(r)
        te.step(r)
    je.pipeline.flush()
    te.pipeline.flush()
    assert len(je.coordinator.partitions) == 2
    assert te.pipeline.flushes == je.pipeline.flushes >= 1
    assert_same_discrete(je, te, MODES_POP["n_clients"])
