"""The sequential oracle in the port (``FLConfig.execution="sequential"``):
against the port's batched round and against the JAX package's sequential
oracle, in one process (child clusterers are seeded from
``hash(child_id)``).

Batched against sequential is held at the reference's own tolerance
(rtol 1e-4, atol 1e-4: tests/test_pipeline.py): the oracle aggregates with
a ``tensordot`` where the fused step runs the segment kernel, so sums run
in another order. The oracle against the JAX package's oracle is held at
the whole-run tolerance (torch_engine_cases).
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import make_population as jmake
from repro.fl.pipeline import RoundPipeline as JPipeline
from repro_torch import random as rnd
from repro_torch.core.coordinator import CohortCoordinator, CohortStats
from repro_torch.core.clustering import OnlineClustering
from repro_torch.data import make_population
from torch_engine_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    one_torch_thread,
    MODES_AUXO, MODES_FL, MODES_POP, RUN_AUXO, RUN_FL, RUN_POP,
    assert_params_close, assert_same_discrete, init_of, jax_engine, partitions, port_engine,
)


@pytest.fixture(scope="module")
def port_pair():
    pop = make_population(**MODES_POP)
    eng_b = port_engine(pop, MODES_FL, MODES_AUXO)
    eng_s = port_engine(pop, MODES_FL, MODES_AUXO, execution="sequential")
    gaps = []
    for r in range(MODES_FL["rounds"]):
        pre_p, pre_o = eng_b.pipeline.bank.params, eng_b.pipeline.bank.opt_state
        eng_s.pipeline.bank.params, eng_s.pipeline.bank.opt_state = pre_p, pre_o
        eng_b.step(r)
        eng_s.step(r)
        gaps.append((r, eng_b.pipeline.bank.params, eng_s.pipeline.bank.params))
    return eng_b, eng_s, gaps


def test_batched_matches_sequential_on_two_partition_run(port_pair):
    """The fused multi-cohort step is numerically the per-cohort path: the
    same plans, partition history and leaves over the 30-round run, and at
    every round, from the same bank, params within fp32 tolerance.

    The oracle's bank is reset to the batched one before each round: the
    two aggregate in different orders, and over a free run one ulp-level
    difference can meet FedYoGi's sign(v - d^2) at v ~ d^2, after which the
    free runs drift apart linearly (6e-7 or 5.5e-4 after 30 rounds, by the
    process's hash seed, which seeds the child clusterers)."""
    eng_b, eng_s, rounds = port_pair
    assert len(eng_b.coordinator.partitions) == 2, partitions(eng_b)
    assert partitions(eng_b) == partitions(eng_s)
    assert eng_b.coordinator.tree.leaves() == eng_s.coordinator.tree.leaves()
    assert eng_b.pipeline.bank.slot_of == eng_s.pipeline.bank.slot_of
    for r, pb, ps in rounds:
        for k in pb:
            np.testing.assert_allclose(ps[k].numpy(), pb[k].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"round {r} {k}")


def test_sequential_dispatch_count_grows_with_cohorts(port_pair):
    """One fused launch per round in batched mode; one per active cohort in
    the oracle."""
    eng_b, eng_s, _ = port_pair
    rounds = MODES_FL["rounds"]
    assert eng_b.pipeline.exec_dispatches == rounds
    assert eng_s.pipeline.exec_dispatches > rounds


def test_sequential_row_keys_are_the_host_threefry_split():
    """The oracle's per-row keys come from split(key(key_seed), B) on the
    host: the JAX package's keys, bit for bit."""
    pop = make_population(**RUN_POP)
    eng = port_engine(pop, RUN_FL, RUN_AUXO, execution="sequential")
    plan = eng.pipeline.plan_round(0)
    xs, ys, keys = eng.pipeline._pack_rows(plan)
    B = plan.slot_rows.shape[0]
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(plan.key_seed), B)))
    assert keys.device.type == "cpu"
    np.testing.assert_array_equal(keys.numpy(), want.astype(np.int64))
    assert xs.shape[0] == ys.shape[0] == B
    np.testing.assert_array_equal(rnd.split(rnd.key(plan.key_seed), B).numpy(), keys.numpy())


def test_per_cohort_feedback_equals_batched_feedback():
    """feedback_all(batched=False) (the oracle's per-cohort calls) gives the
    batched pass's assignments and rewards."""
    rng = np.random.default_rng(4)
    C, P, d = 2, 16, 8
    sk = torch.from_numpy(rng.normal(size=(C, P, d)).astype(np.float32))
    m = torch.ones(C, P)
    m[0, 10:] = 0
    ids = [list(range(10)), list(range(50, 66))]
    out = {}
    for batched in (True, False):
        co = CohortCoordinator(d_sketch=d, seed=0, clustering_start_frac=0.0, device="cpu")
        children = co.tree.partition("0", 2)
        for i, ch in enumerate(children):
            co.clusterers[ch] = OnlineClustering(2, d, seed=i + 1, device="cpu")
            co.stats[ch] = CohortStats()
        out[batched] = [
            [(fb.assign.tolist(), fb.delta) for fb in
             co.feedback_all(children, ids, sk + 0.05 * r, m, r, 100, batched=batched)]
            for r in range(3)
        ]
    for a, b in zip(out[True], out[False]):
        for (aa, da), (ab, db) in zip(a, b):
            assert aa == ab
            np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


def test_sequential_matches_reference_sequential():
    """The whole run in both packages' oracles, from the same initial
    weights: same partitions, slots, assignments, counts and launch count;
    params within the whole-run tolerance; the same leaf composition."""
    je = jax_engine(jmake(**RUN_POP), RUN_FL, RUN_AUXO, execution="sequential")
    assert isinstance(je.pipeline, JPipeline) and je.pipeline.mode == "sequential"
    je.run()
    te = port_engine(make_population(**RUN_POP), RUN_FL, RUN_AUXO, init=init_of(je),
                     execution="sequential")
    te.run()
    assert je.coordinator.partitions, "the scenario must partition"
    assert_same_discrete(je, te, RUN_POP["n_clients"])
    assert_params_close(je, te)
    assert te.serving_cohorts() == je.serving_cohorts()


def test_sequential_discrete_outcomes_match_reference_on_two_partitions():
    """The 30-round scenario in both oracles: two partitions at the same
    rounds, the same assignments, counts and launches (params: see
    torch_engine_cases)."""
    je = jax_engine(jmake(**MODES_POP), MODES_FL, MODES_AUXO, execution="sequential")
    te = port_engine(make_population(**MODES_POP), MODES_FL, MODES_AUXO, init=init_of(je),
                     execution="sequential")
    for r in range(MODES_FL["rounds"]):
        je.step(r)
        te.step(r)
    assert len(je.coordinator.partitions) == 2
    assert_same_discrete(je, te, MODES_POP["n_clients"])
