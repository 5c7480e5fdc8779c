"""Evaluation and coordinator failover in the port against the JAX package,
in one process (child clusterers are seeded from ``hash(child_id)``):
``AuxoEngine.ftfa_eval``, ``client_cluster_index``, ``_probe_fingerprint``
and ``_apply_partition``; ``CohortCoordinator.feedback``, ``checkpoint``,
``recover`` and ``rebuild_from_requests``; ``CohortSelector.select``,
``update_rewards``, ``qfedavg_weights``; ``TransformerTask.correct_fraction``
over stacked rows.

Tolerances: discrete outcomes (assignments, partition events, blacklists,
cluster indices, host RNG streams) are EQUAL. Whole-run params and the
personalised models hold at tests/test_torch_round.py's rtol 1e-4 /
atol 1e-5; per-call floats (rewards, identities, clusterer states) at
tests/test_torch_core.py's 1e-5.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.core import selection as jsel
from repro.core.clustering import OnlineClustering as JOnline
from repro.core.coordinator import CohortCoordinator as JCoord
from repro.core.coordinator import CohortStats as JStats
from repro.core.coordinator import PartitionEvent as JEvent
from repro.core.criteria import PartitionCriteria as JCrit
from repro.fl.algorithms import qfedavg_weights as jq
from repro.fl.task import TransformerTask as JTTask
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.core import CohortSelector, update_rewards
from repro_torch.core.clustering import OnlineClustering as TOnline
from repro_torch.core.coordinator import CohortCoordinator as TCoord
from repro_torch.core.coordinator import CohortStats as TStats
from repro_torch.core.coordinator import PartitionEvent as TEvent
from repro_torch.core.criteria import PartitionCriteria as TCrit
from repro_torch.fl import engine as tengine
from repro_torch.fl.algorithms import qfedavg_weights as tq
from repro_torch.fl.task import TransformerTask as TTTask
from repro_torch.models import build_model as tbuild
from repro_torch.utils.tree import tree_map

from torch_engine_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    RUN_AUXO,
    RUN_FL,
    RUN_POP,
    init_of,
    jax_engine,
    one_torch_thread,
    port_engine,
)

RTOL, ATOL = 1e-4, 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the engines
@pytest.fixture(scope="module")
def engines():
    """tests/test_torch_round.py's 120-client, 12-round run in both
    packages from the JAX package's initial weights."""
    from repro.data import make_population as jmake
    from repro_torch.data import make_population as tmake

    je = jax_engine(jmake(**RUN_POP), RUN_FL, RUN_AUXO)
    je.run()
    te = port_engine(tmake(**RUN_POP), RUN_FL, RUN_AUXO, init=init_of(je))
    te.run()
    assert je.coordinator.partitions, "the scenario must partition"
    return je, te


@pytest.fixture(scope="module")
def ftfa(engines, monkeypatch_module):
    """ftfa_eval(steps=5) in both packages, with the personalised params
    (the rows' params plus their fine-tuning deltas) captured."""
    je, te = engines
    seen = {}
    jtrain = je._vmapped_train_rows

    def jrec(p, xs, ys, k):
        out = jtrain(p, xs, ys, k)
        seen["jax"] = jax.tree.map(lambda a, b: np.asarray(a + b), p, out[0])
        return out

    je._vmapped_train_rows = jrec
    ttrain = tengine.local_train

    def trec(loss, p, *a, **k):
        out = ttrain(loss, p, *a, **k)
        seen["port"] = tree_map(lambda u, v: (u + v).numpy(), p, out[0])
        return out

    monkeypatch_module.setattr(tengine, "local_train", trec)
    jv = je.ftfa_eval(steps=5)
    tv = te.ftfa_eval(steps=5)
    monkeypatch_module.undo()
    je._vmapped_train_rows = jtrain
    return jv, tv, seen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_ftfa_value_matches_jax(ftfa):
    jv, tv, _ = ftfa
    assert 0.0 <= tv <= 1.0
    assert abs(tv - jv) <= 1e-6, (jv, tv)


def test_ftfa_personalised_params_match_jax(ftfa):
    _, _, seen = ftfa
    n = RUN_POP["n_clients"]
    assert set(seen["port"]) == set(seen["jax"])
    for k, want in seen["jax"].items():
        assert want.shape[0] == len(range(0, n, max(1, n // 100)))
        np.testing.assert_allclose(seen["port"][k], want, rtol=RTOL, atol=ATOL, err_msg=k)


def test_ftfa_advances_the_training_rng_like_jax(engines, ftfa):
    je, te = engines
    assert te.rng.bit_generator.state == je.rng.bit_generator.state
    assert te.rng.random() == je.rng.random()


def test_client_cluster_index_matches_jax(engines):
    je, te = engines
    assert te.pipeline.bank.slot_of == je.pipeline.bank.slot_of
    for cid in list(je.pipeline.bank.slot_of) + ["9.9"]:
        got = [te.client_cluster_index(c, cid) for c in range(RUN_POP["n_clients"])]
        want = [je.client_cluster_index(c, cid) for c in range(RUN_POP["n_clients"])]
        assert got == want, cid
    assert te.client_cluster_index(0, "9.9") == -1


def test_probe_fingerprint_matches_jax(engines):
    je, te = engines
    for c in (0, 7, 63, 119):
        want = je._probe_fingerprint(c)
        got = te._probe_fingerprint(c)
        assert got.shape == want.shape == (RUN_AUXO["d_sketch"],)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=str(c))


def test_apply_partition_matches_jax():
    """A partition applied by hand: the children are warm-started from the
    parent slot and seeded with its rewards, R + 0.1·1(L == k)."""
    from repro.data import make_population as jmake
    from repro_torch.data import make_population as tmake

    je = jax_engine(jmake(**RUN_POP), RUN_FL, RUN_AUXO)
    te = port_engine(tmake(**RUN_POP), RUN_FL, RUN_AUXO, init=init_of(je))
    rng = np.random.default_rng(3)
    n = RUN_POP["n_clients"]
    rw = rng.standard_normal(n).astype(np.float32)
    cl = rng.integers(-1, 2, n).astype(np.int32)
    for eng in (je, te):
        t = eng.pipeline.table
        t.reward[:, 0], t.known[:, 0], t.cluster_idx[:, 0] = rw, True, cl
        # the event as the coordinator hands it over, before its tree splits
        children = ["0.0", "0.1"]
        ev = (JEvent if eng is je else TEvent)("0", children, 3, dict(enumerate(children)))
        eng._apply_partition(ev)
    assert te.pipeline.bank.slot_of == je.pipeline.bank.slot_of
    for name in ("reward", "known", "cluster_idx"):
        np.testing.assert_array_equal(getattr(te.pipeline.table, name), getattr(je.pipeline.table, name))
    for cid, slot in je.pipeline.bank.slot_of.items():
        for k, v in je.pipeline.bank.params.items():
            np.testing.assert_array_equal(te.pipeline.bank.params[k][slot].numpy(), np.asarray(v)[slot])


# ----------------------------------------------------- coordinator feedback
def _crit(pkg):
    return pkg(k=2, min_members=8, start_frac=0.0, margin_threshold=0.3, het_reduction_slack=3.0)


def _pair(host=False, **kw):
    """tests/test_coordinator.py's coordinator in both packages."""
    base = dict(d_sketch=16, cluster_k=2, clustering_start_frac=0.0)
    base.update(kw)
    jco = JCoord(criteria=_crit(JCrit), **base)
    tco = TCoord(criteria=_crit(TCrit), device="cpu", **base)
    if host:
        tco.use_host_states()
    return jco, tco


def _two_group(rng, n=60, d=16, noise=0.1):
    a = rng.normal(size=d)
    b = rng.normal(size=d)
    x = np.stack([(a if i % 2 == 0 else b) + noise * rng.normal(size=d) for i in range(n)])
    return x.astype(np.float32)


def _same_feedback(jout, tout):
    (jm, jev), (tm, tev) = jout, tout
    assert list(tm) == list(jm)
    for cid, a in jm.items():
        b = tm[cid]
        assert (b.cohort_id, b.cluster_index) == (a.cohort_id, a.cluster_index), cid
        assert abs(b.reward - a.reward) <= 1e-5 * max(1.0, abs(a.reward)), cid
    assert (jev is None) == (tev is None)
    if jev is not None:
        assert (tev.parent, tev.children, tev.round_idx, tev.cluster_to_child) == (
            jev.parent, jev.children, jev.round_idx, jev.cluster_to_child)


def _same_state(jco, tco):
    assert tco.tree.leaves() == jco.tree.leaves()
    assert tco.strikes == jco.strikes and tco.blacklist == jco.blacklist
    assert tco.identity.keys() == jco.identity.keys()
    for cid in jco.identity:
        np.testing.assert_allclose(tco.identity[cid], jco.identity[cid], **TOL)
    for cid, st in jco.stats.items():
        ts = tco.stats[cid]
        assert (ts.rounds_trained, ts.initial_participants) == (st.rounds_trained, st.initial_participants)
        assert abs(ts.initial_heterogeneity - st.initial_heterogeneity) <= 1e-5 * max(1.0, st.initial_heterogeneity)


@pytest.mark.parametrize("host", [False, True], ids=["device_states", "host_states"])
def test_feedback_partitions_separable_population_like_jax(host):
    rng = np.random.default_rng(0)
    jco, tco = _pair(host)
    events = 0
    for r in range(30):
        sk = _two_group(rng)
        jout = jco.feedback("0", list(range(60)), jnp.asarray(sk), r, 30)
        tout = tco.feedback("0", list(range(60)), torch.from_numpy(sk), r, 30)
        _same_feedback(jout, tout)
        _same_state(jco, tco)
        if jout[1]:
            events += 1
            break
    assert events == 1 and tco.tree.leaves() == ["0.0", "0.1"]
    if host:
        assert all(isinstance(cl.state.centroids, np.ndarray) for cl in tco.clusterers.values())


@pytest.mark.parametrize("host", [False, True], ids=["device_states", "host_states"])
def test_feedback_keeps_homogeneous_population_whole_like_jax(host):
    rng = np.random.default_rng(1)
    jco, tco = _pair(host)
    base = rng.normal(size=16)
    for r in range(30):
        sk = (base + 0.05 * rng.normal(size=(60, 16))).astype(np.float32)
        jout = jco.feedback("0", list(range(60)), jnp.asarray(sk), r, 30)
        tout = tco.feedback("0", list(range(60)), sk, r, 30)  # numpy in
        _same_feedback(jout, tout)
        assert tout[1] is None
    _same_state(jco, tco)


@pytest.mark.parametrize("host", [False, True], ids=["device_states", "host_states"])
def test_feedback_blacklists_anomalies_like_jax(host):
    rng = np.random.default_rng(3)
    jco, tco = _pair(host, anomaly_threshold=-0.2, anomaly_strikes=2)
    for r in range(4):
        sk = _two_group(rng, n=40, noise=0.05)
        sk[0] = 80.0 * rng.normal(size=16)  # client 0 is a wild outlier
        claimed = [True] + [False] * 39
        # padded to 48 rows, the last 8 masked out
        pad = np.concatenate([sk, np.zeros((8, 16), np.float32)])
        mask = np.concatenate([np.ones(40), np.zeros(8)]).astype(np.float32)
        jout = jco.feedback("0", list(range(40)), jnp.asarray(pad), r, 20, claimed, jnp.asarray(mask))
        tout = tco.feedback("0", list(range(40)), torch.from_numpy(pad), r, 20, claimed,
                            torch.from_numpy(mask))
        _same_feedback(jout, tout)
        _same_state(jco, tco)
    assert 0 in tco.blacklist
    assert tco.match_request(0, "0") is None


def test_feedback_matches_feedback_all():
    """Per-cohort feedback() calls == one batched feedback_all, cohort by
    cohort (tests/test_coordinator.py's case), and both == the JAX
    package's feedback()."""
    rng = np.random.default_rng(7)

    def partitioned(pkg):
        if pkg == "jax":
            co = JCoord(d_sketch=16, cluster_k=2, criteria=_crit(JCrit), clustering_start_frac=0.0)
            co.tree.partition("0", 2)
            for ch in ("0.0", "0.1"):
                co.clusterers[ch] = JOnline(2, 16, seed=5)
                co.stats[ch] = JStats()
            return co
        co = TCoord(d_sketch=16, cluster_k=2, criteria=_crit(TCrit), clustering_start_frac=0.0,
                    device="cpu")
        co.tree.partition("0", 2)
        for ch in ("0.0", "0.1"):
            co.clusterers[ch] = TOnline(2, 16, seed=5, device="cpu")
            co.stats[ch] = TStats()
        return co

    co_j, co_a, co_b = partitioned("jax"), partitioned("port"), partitioned("port")
    for r in range(6):
        sks = [_two_group(rng, n=24) for _ in ("0.0", "0.1")]
        ids = [list(range(24)), list(range(100, 124))]
        per = []
        for c, cid in enumerate(("0.0", "0.1")):
            jout = co_j.feedback(cid, ids[c], jnp.asarray(sks[c]), r, 40)
            tout = co_a.feedback(cid, ids[c], torch.from_numpy(sks[c]), r, 40)
            _same_feedback(jout, tout)
            per.append(tout[0])
        out = co_b.feedback_all(["0.0", "0.1"], ids, torch.from_numpy(np.stack(sks)),
                                torch.ones((2, 24)), r, 40)
        for c in range(2):
            np.testing.assert_allclose(out[c].delta, [per[c][i].reward for i in ids[c]], **TOL)
            np.testing.assert_array_equal(out[c].assign, [per[c][i].cluster_index for i in ids[c]])
    for cid in ("0.0", "0.1"):
        ca, cb = co_a.clusterers[cid].state, co_b.clusterers[cid].state
        np.testing.assert_allclose(ca.centroids.numpy(), cb.centroids.numpy(), rtol=1e-5, atol=1e-6)
        assert float(ca.dispersion) == pytest.approx(float(cb.dispersion), rel=1e-5)
        np.testing.assert_allclose(ca.centroids.numpy(), np.asarray(co_j.clusterers[cid].state.centroids), **TOL)


# ------------------------------------------------------------- failover
@pytest.fixture(scope="module")
def partitioned_pair():
    """Both packages' coordinators after tests/test_coordinator.py's
    checkpoint scenario (a partition), with client 42 blacklisted."""
    rng = np.random.default_rng(4)
    jco, tco = _pair()
    for r in range(30):
        sk = _two_group(rng)
        jout = jco.feedback("0", list(range(60)), jnp.asarray(sk), r, 30)
        tco.feedback("0", list(range(60)), torch.from_numpy(sk), r, 30)
        if jout[1]:
            break
    assert jco.partitions and len(tco.partitions) == len(jco.partitions)
    jco.blacklist.add(42)
    tco.blacklist.add(42)
    return jco, tco


def _plain_objects_only(obj):
    if isinstance(obj, dict):
        return all(_plain_objects_only(k) and _plain_objects_only(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return all(_plain_objects_only(v) for v in obj)
    return obj is None or isinstance(obj, (str, int, float, np.ndarray, np.generic))


def test_checkpoints_hold_the_same_state(tmp_path, partitioned_pair):
    jco, tco = partitioned_pair
    jco.checkpoint(tmp_path / "j.ckpt")
    tco.checkpoint(tmp_path / "t.ckpt")
    js, ts = (pickle.loads((tmp_path / n).read_bytes()) for n in ("j.ckpt", "t.ckpt"))
    assert _plain_objects_only(ts)
    assert "torch" not in (tmp_path / "t.ckpt").read_bytes().decode("latin-1")
    for key in ("tree_nodes", "cluster_k", "d_sketch", "blacklist", "partitions"):
        assert ts[key] == js[key], key
    assert ts["clusterer_states"].keys() == js["clusterer_states"].keys()
    for cid, want in js["clusterer_states"].items():
        got = ts["clusterer_states"][cid]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL, err_msg=cid)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recover_across_packages(tmp_path, partitioned_pair, writer):
    jco, tco = partitioned_pair
    path = tmp_path / f"{writer}.ckpt"
    (jco if writer == "jax" else tco).checkpoint(path)
    jr = JCoord.recover(path)
    tr = TCoord.recover(path, device="cpu")
    assert tr.tree.leaves() == jr.tree.leaves() == jco.tree.leaves()
    assert {c: (n.parent, n.children) for c, n in tr.tree.nodes.items()} == {
        c: (n.parent, n.children) for c, n in jr.tree.nodes.items()}
    assert tr.blacklist == jr.blacklist == {42}
    assert [dataclasses.asdict(p) for p in tr.partitions] == [dataclasses.asdict(p) for p in jr.partitions]
    assert tr.clusterers.keys() == jr.clusterers.keys()
    assert tr.stats.keys() == jr.stats.keys()
    for cid, cl in tr.clusterers.items():
        assert cl.state.centroids.device.type == "cpu" and not bool(cl.state.initialized)
        np.testing.assert_array_equal(cl._key.numpy(), np.asarray(jax.random.key_data(jr.clusterers[cid]._key)))


@pytest.mark.parametrize("host", [False, True], ids=["device_states", "host_states"])
def test_rebuild_from_requests_matches_jax(host):
    reqs = [(1, "0.0", 0), (2, "0.1", 1), (3, "0.1.0", 0), (4, "0.1.1.1", 1), (5, "0.0", 1)]
    jco, tco = _pair(host)
    jco.rebuild_from_requests(reqs)
    tco.rebuild_from_requests(reqs)
    assert {c: (n.parent, n.children) for c, n in tco.tree.nodes.items()} == {
        c: (n.parent, n.children) for c, n in jco.tree.nodes.items()}
    assert tco.tree.leaves() == jco.tree.leaves()
    assert tco.clusterers.keys() == jco.clusterers.keys() and tco.stats.keys() == jco.stats.keys()
    assert all(isinstance(cl.state.centroids, np.ndarray) == host for cl in tco.clusterers.values())


# ------------------------------------------------------ selection and q-FedAvg
def test_select_and_update_rewards_match_jax():
    jsr, tsr = np.random.default_rng(11), np.random.default_rng(11)
    js, ts = jsel.CohortSelector(), CohortSelector()
    draw = np.random.default_rng(12)
    leaves = ["0.0", "0.1", "0.1.0"]
    picks = []
    for r in range(200):
        rewards = {} if r % 7 == 0 else {l: float(draw.standard_normal()) for l in leaves[: 1 + r % 3]}
        lv = leaves[: 1 + (r * 5) % 3]
        want = js.select(jsr, rewards, lv, r)
        got = ts.select(tsr, rewards, lv, r)
        assert got == want, r
        picks.append(got)
        assert ts.epsilon(r) == js.epsilon(r)
    assert tsr.bit_generator.state == jsr.bit_generator.state
    assert len(set(picks)) == 3  # exploration and exploitation both ran
    with pytest.raises(ValueError):
        ts.select(tsr, {}, [], 0)
    prev = 0.0
    for d in draw.standard_normal(20):
        for g in (0.2, 0.5):
            assert update_rewards(prev, float(d), g) == jsel.update_rewards(prev, float(d), g)
        prev = update_rewards(prev, float(d))


@pytest.mark.parametrize("q", [0.0, 0.5, 1.0, 3.0])
def test_qfedavg_weights_match_jax(q):
    losses = np.array([2.3, 0.1, 0.0, -1.0, 1e-8, 5.0, 0.7], np.float32)
    want = np.asarray(jq(jnp.asarray(losses), q))
    got = tq(torch.from_numpy(losses), q).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.sum() == pytest.approx(1.0, rel=1e-6)
    np.testing.assert_array_equal(tq(torch.zeros(3), q).numpy(), np.asarray(jq(jnp.zeros(3), q)))


# ------------------------------------------- TransformerTask, stacked rows
def test_transformer_correct_fraction_scores_each_row():
    """Reduced granite-3-2b: three rows of params (R, ...) over tokens
    (R, B, S) give one score per row, each the unstacked call's and the
    JAX package's vmapped one."""
    jm = jbuild(jreduce(jget("granite_3_2b")))
    tm = tbuild(treduce(tget("granite_3_2b")))
    R = 3
    jps = [jm.init(jax.random.key(i)) for i in range(R)]
    jstack = jax.tree.map(lambda *ls: jnp.stack(ls), *jps)
    tstack = params_from_numpy(jax.tree.map(np.asarray, jstack), "cpu")
    tok = np.random.default_rng(5).integers(0, jm.cfg.vocab, size=(R, 2, 16)).astype(np.int32)
    tok[..., 8:] = tok[..., :8]  # a repeat, so some next tokens are predictable
    want = np.asarray(jax.vmap(JTTask(jm).correct_fraction)(jstack, jnp.asarray(tok)))
    task = TTTask(tm)
    got = task.correct_fraction(tstack, torch.from_numpy(tok))
    assert tuple(got.shape) == (R,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    for j in range(R):
        one = task.correct_fraction(tree_map(lambda a: a[j], tstack), torch.from_numpy(tok[j]))
        assert one.dim() == 0 and float(one) == float(got[j])
