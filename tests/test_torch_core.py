"""The port's Auxo core (repro_torch.core) against the JAX package's
(repro.core) on the same numpy-made inputs and the same threefry keys.

Discrete outcomes (assignments, k-means seeds, partition decisions) must be
EQUAL; float outputs agree within 1e-5 — the two frameworks sum in
different orders, and XLA fuses what torch runs op by op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.core import selection as jsel
from repro.core.coordinator import CohortCoordinator as JCoord
from repro.core.criteria import PartitionCriteria as JCrit
from repro.core.sketch import GradientSketcher as JSketcher
from repro_torch import random as trnd
from repro_torch.convert import cluster_state_from_numpy
from repro_torch.core import clustering as tcl
from repro_torch.core import selection as tsel
from repro_torch.core.coordinator import CohortCoordinator as TCoord
from repro_torch.core.criteria import PartitionCriteria as TCrit
from repro_torch.core.sketch import GradientSketcher as TSketcher

TOL = dict(rtol=1e-5, atol=1e-5)
MLP_SHAPES = {"w0": (32, 64), "w1": (64, 64), "w2": (64, 10), "b0": (64,), "b1": (64,), "b2": (10,)}


def _clustered(rng, C, P, d, sep=3.0):
    """(C, P, d) sketches drawn around two directions per cohort."""
    dirs = rng.standard_normal((C, 2, d)).astype(np.float32) * sep
    lab = rng.integers(0, 2, (C, P))
    x = dirs[np.arange(C)[:, None], lab] + rng.standard_normal((C, P, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.mark.parametrize("strategy", ["last_block_proj", "full_proj"])
def test_sketcher_matches_jax(strategy):
    rng = np.random.default_rng(0)
    R = 5
    deltas = {k: (0.01 * rng.standard_normal((R,) + s)).astype(np.float32) for k, s in MLP_SHAPES.items()}
    kw = dict(d_sketch=64, strategy=strategy, path_filter=("'w2'", "'b2'"))
    want = np.asarray(jax.vmap(JSketcher(**kw))({k: jnp.asarray(v) for k, v in deltas.items()}))
    got = TSketcher(**kw).batch({k: torch.from_numpy(v) for k, v in deltas.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_kmeans_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = _clustered(rng, 1, 48, 32)[0]
    m = np.ones(48, np.float32)
    m[40:] = 0.0  # padded rows
    jc, ja = jcl.kmeans_cosine(jax.random.key(seed), jnp.asarray(x), 2, mask=jnp.asarray(m))
    tc, ta = tcl.kmeans_cosine(trnd.key(seed), torch.from_numpy(x), 2, mask=torch.from_numpy(m))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_kmeans_bootstrap_batched_matches_jax():
    rng = np.random.default_rng(5)
    C, P, d = 3, 32, 16
    x = _clustered(rng, C, P, d)
    m = (rng.random((C, P)) < 0.85).astype(np.float32)
    jkeys = jax.random.split(jax.random.key(9), C)
    tkeys = trnd.split(trnd.key(9), C)
    jc, ja = jcl.kmeans_bootstrap_batched(jkeys, jnp.asarray(x), jnp.asarray(m), 2)
    tc, ta = tcl.kmeans_bootstrap_batched(tkeys, torch.from_numpy(x), torch.from_numpy(m), 2)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def _state(rng, C, k, d):
    cents = rng.standard_normal((C, k, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=-1, keepdims=True)
    return dict(
        centroids=cents,
        counts=rng.random((C, k)).astype(np.float32) * 10,
        round_counts=rng.random((C, k)).astype(np.float32) * 10,
        dispersion=rng.random(C).astype(np.float32),
        margin=rng.random(C).astype(np.float32),
        cluster_dispersion=rng.random((C, k)).astype(np.float32),
        initialized=np.ones(C, bool),
        round=np.full(C, 3, np.int32),
    )


def test_assign_and_update_matches_jax():
    rng = np.random.default_rng(11)
    C, P, d, k = 4, 32, 16, 2
    x = _clustered(rng, C, P, d)
    m = (rng.random((C, P)) < 0.8).astype(np.float32)
    fields = _state(rng, C, k, d)
    jstate = jcl.ClusterState(**{n: jnp.asarray(v) for n, v in fields.items()})
    tstate = cluster_state_from_numpy(device="cpu", **fields)
    js, ja, jsims = jcl.assign_and_update_batched(jstate, jnp.asarray(x), jnp.asarray(m), 0.3)
    ts, ta, tsims = tcl.assign_and_update_batched(tstate, torch.from_numpy(x), torch.from_numpy(m), 0.3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tsims.numpy(), np.asarray(jsims), **TOL)
    for f in dataclasses.fields(jcl.ClusterState):
        np.testing.assert_allclose(
            getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)), **TOL, err_msg=f.name
        )
    # the single-cohort entry point agrees with its batched form
    one = cluster_state_from_numpy(device="cpu", **{n: v[0] for n, v in fields.items()})
    s1, a1, _ = tcl.assign_and_update(one, torch.from_numpy(x[0]), torch.from_numpy(m[0]))
    np.testing.assert_array_equal(a1.numpy(), ta[0].numpy())
    np.testing.assert_allclose(s1.centroids.numpy(), ts.centroids[0].numpy(), **TOL)


def test_instant_reward_and_heterogeneity_match_jax():
    rng = np.random.default_rng(2)
    x = _clustered(rng, 3, 40, 24)
    m = (rng.random((3, 40)) < 0.7).astype(np.float32)
    jd, jdist = jsel.instant_reward_batched(jnp.asarray(x), jnp.asarray(m))
    td, tdist = tsel.instant_reward_batched(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), **TOL)
    d1, _ = tsel.instant_reward(torch.from_numpy(x[1]), torch.from_numpy(m[1]))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jsel.instant_reward(x[1], m[1])[0]), **TOL)
    jh = float(jcl.population_heterogeneity(jnp.asarray(x[0]), jnp.asarray(m[0])))
    th = float(tcl.population_heterogeneity(torch.from_numpy(x[0]), torch.from_numpy(m[0])))
    assert abs(jh - th) <= 1e-5 * max(1.0, abs(jh))


def test_feedback_all_matches_jax():
    """Rounds of coordinator feedback on the same stacked sketches: the
    assignments, rewards and partition decisions must be equal."""
    rng = np.random.default_rng(4)
    d, P, total = 32, 32, 20
    crit = dict(k=2, min_members=4, start_frac=0.1, end_frac=0.9, margin_threshold=0.3)
    kw = dict(d_sketch=d, cluster_k=2, clustering_start_frac=0.05, max_cohorts=3, seed=3)
    jco = JCoord(criteria=JCrit(**crit), **kw)
    tco = TCoord(criteria=TCrit(**crit), device="cpu", **kw)
    dirs = rng.standard_normal((2, d)).astype(np.float32) * 3
    events = []
    for r in range(1, 12):
        leaves = jco.tree.leaves()
        assert leaves == tco.tree.leaves()
        C = len(leaves)
        lab = rng.integers(0, 2, (C, P))
        x = (dirs[lab] + rng.standard_normal((C, P, d))).astype(np.float32)
        n = rng.integers(P // 2, P + 1, C)
        m = (np.arange(P)[None, :] < n[:, None]).astype(np.float32)
        ids = [list(range(100 * c, 100 * c + int(n[c]))) for c in range(C)]
        claimed = [rng.random(int(n[c])) < 0.5 for c in range(C)]
        jr = jco.feedback_all(leaves, ids, jnp.asarray(x), jnp.asarray(m), r, total, claimed)
        tr = tco.feedback_all(leaves, ids, torch.from_numpy(x), torch.from_numpy(m), r, total, claimed)
        for a, b in zip(jr, tr):
            assert a.cohort_id == b.cohort_id and a.client_ids == b.client_ids
            np.testing.assert_array_equal(b.assign, a.assign)
            np.testing.assert_allclose(b.delta, a.delta, **TOL)
            assert (a.event is None) == (b.event is None)
            if a.event is not None:
                assert (a.event.parent, a.event.children) == (b.event.parent, b.event.children)
                events.append(a.event.parent)
        assert jco.strikes == tco.strikes and jco.blacklist == tco.blacklist
        for cid in jco.identity:
            np.testing.assert_allclose(tco.identity[cid], jco.identity[cid], **TOL)
    assert events, "the scenario must exercise a partition"
