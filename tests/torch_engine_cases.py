"""Scenarios and comparisons shared by the port's engine-mode tests
(test_torch_sequential.py, test_torch_overlap.py, test_torch_population.py).

Two scenarios:
- ``MODES_*``: tests/test_pipeline.py's (300 clients, 4 groups, 60
  participants, 30 rounds, two partitions). The port's modes are held
  against each other here, bit for bit or at the reference's own tolerance.
- ``RUN_*``: tests/test_torch_round.py's whole run (examples/quickstart.py
  scaled to 120 clients / 12 rounds). Each mode is held against the JAX
  package's same mode here, from the same initial weights: discrete outcomes
  equal, params within rtol 1e-4 / atol 1e-5.

On the 30-round scenario the two packages' discrete outcomes stay equal in
every mode, but their params drift apart past the whole-run tolerance from
round 7 on (3e-3 by round 30, the synchronous batched mode included): a
hidden unit whose pre-activation sits at the ReLU kink trains in one
package and not in the other for one sample, and FedYoGi's
sign(v - d^2) amplifies such flips. So the long scenario is compared on
discrete outcomes only across packages.
"""
import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module's tests run (modules import this
    fixture). The engines launch thousands of tiny CPU ops; with every
    pytest worker's OpenMP pool as wide as the machine, the pools' spinning
    threads oversubscribe the cores and a 3 s run takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES_POP = dict(n_clients=300, n_groups=4, group_sep=0.0, dirichlet=3.0,
                 label_conflict=1.0, seed=5)
MODES_FL = dict(rounds=30, participants_per_round=60, eval_every=29,
                use_availability=False, seed=5)
MODES_AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=3, clustering_start_frac=0.03,
                  partition_start_frac=0.08, partition_end_frac=0.9, min_members=6,
                  margin_threshold=0.35)

RUN_POP = dict(n_clients=120, n_groups=2, group_sep=0.0, dirichlet=2.0,
               label_conflict=0.6, seed=0)
RUN_FL = dict(rounds=12, participants_per_round=40, eval_every=4, seed=0,
              use_availability=False)
RUN_AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=2, clustering_start_frac=0.05,
                partition_start_frac=0.1, min_members=8)


def port_engine(pop, fl_kw, auxo_kw, init=None, **fl_over):
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    return AuxoEngine(
        MLPTask(dim=pop.dim, n_classes=pop.n_classes), pop, FLConfig(**{**fl_kw, **fl_over}),
        AuxoConfig(**auxo_kw), device="cpu", init_params=init,
    )


def jax_engine(pop, fl_kw, auxo_kw, **fl_over):
    from repro.fl import AuxoConfig, AuxoEngine, FLConfig
    from repro.fl.task import MLPTask

    return AuxoEngine(
        MLPTask(dim=pop.dim, n_classes=pop.n_classes), pop, FLConfig(**{**fl_kw, **fl_over}),
        AuxoConfig(**auxo_kw),
    )


def init_of(jax_eng):
    """The JAX engine's initial weights as numpy (the port's init_params)."""
    return {k: np.asarray(v) for k, v in jax_eng._init_params.items()}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def partitions(eng):
    return [(e.parent, tuple(e.children), e.round_idx) for e in eng.coordinator.partitions]


def host_state(eng, n):
    """Per-client soft state as dense numpy arrays (dense or store engine,
    either package): tables, fingerprints, flags, streaks."""
    t = eng.pipeline.table
    if hasattr(t, "to_dense"):
        rw, kn, cl = t.to_dense(n)
        fp = eng.store.to_dense("fingerprint", n)
        seen = eng.store.to_dense("fp_seen", n)
        streak = eng.store.to_dense("neg_streak", n)
    else:
        rw, kn, cl = t.reward, t.known, t.cluster_idx
        fp, seen, streak = eng.fingerprint, eng.fp_seen, eng.neg_streak
    return dict(reward=rw, known=kn, cluster_idx=cl, fingerprint=fp, fp_seen=seen,
                neg_streak=streak)


def assert_same_discrete(ja, tb, n):
    """Partitions, leaves, slots, per-client assignments (cluster indices)
    and every clusterer's cumulative counts are equal."""
    assert partitions(ja) == partitions(tb)
    assert ja.coordinator.tree.leaves() == tb.coordinator.tree.leaves()
    assert ja.pipeline.bank.slot_of == tb.pipeline.bank.slot_of
    np.testing.assert_array_equal(host_state(ja, n)["cluster_idx"], host_state(tb, n)["cluster_idx"])
    assert sorted(ja.coordinator.clusterers) == sorted(tb.coordinator.clusterers)
    for cid, cl in ja.coordinator.clusterers.items():
        np.testing.assert_array_equal(
            _np(cl.state.counts), _np(tb.coordinator.clusterers[cid].state.counts), err_msg=cid
        )
    assert ja.pipeline.exec_dispatches == tb.pipeline.exec_dispatches


def assert_params_close(ja, tb, rtol=RTOL, atol=ATOL):
    for k, v in ja.pipeline.bank.params.items():
        np.testing.assert_allclose(_np(tb.pipeline.bank.params[k]), _np(v), rtol=rtol, atol=atol,
                                   err_msg=k)


def assert_bit_equal(ea, eb, n):
    """Two port engines: every observable identical (bank params and
    optimizer state, partitions, tables, fingerprints)."""
    assert partitions(ea) == partitions(eb)
    assert ea.coordinator.tree.leaves() == eb.coordinator.tree.leaves()
    ba, bb = ea.pipeline.bank, eb.pipeline.bank
    for k, v in ba.params.items():
        assert torch.equal(v, bb.params[k]), k
    for g, tree in ba.opt_state.items():
        for k, v in tree.items():
            assert torch.equal(v, bb.opt_state[g][k]), (g, k)
    sa, sb = host_state(ea, n), host_state(eb, n)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def run_stale_sync(eng, rounds: int, barrier=lambda: None):
    """Port copy of tests/test_round_overlap.py's oracle: the §⑤ host
    schedule (plan round r BEFORE round r-1's feedback is applied, flush on
    partition) on a synchronous pipeline, with ``barrier`` after every
    dispatch and every result read eagerly. Same host-RNG and table-op order
    as run_round's overlapped path; only the asynchrony differs."""
    p = eng.pipeline
    assert p.overlap == 0
    p.host_control = True  # the overlapped path's control-plane math
    staged = None
    inflight = None
    for r in range(rounds):
        prev, inflight = inflight, None
        if staged is not None and staged[0] == r:
            _, plan, packed = staged
        else:
            _, plan, packed = p._plan_and_pack(r)
        staged = None
        res = p.execute(plan, packed) if plan is not None else None
        barrier()
        if res is not None:
            res.sketches, res.losses
        events = prev is not None and p.apply_feedback(*prev)
        if plan is not None:
            if events:
                p.apply_feedback(plan, res)  # flush: drain the stale round
            else:
                inflight = (plan, res)
        staged = p._plan_and_pack(r + 1)
    if inflight is not None:
        p.apply_feedback(*inflight)
    return eng
