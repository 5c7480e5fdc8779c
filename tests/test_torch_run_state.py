"""Whole-run checkpoints of the port (``repro_torch.checkpoint.save_run`` /
``load_run``), held like tests/test_elastic_restore.py holds the JAX
package's: a run saved at round k, reloaded and continued must end
BIT-EQUAL to a run that never stopped (bank, clocks, tables, fingerprints,
probe caches and the evaluation), over the reference's matrix of planes,
overlap modes and save points; restores onto another shard count (2 -> 4,
2 -> 1) likewise. Then checkpoints cross between the two packages in both
directions and continue within the whole-run tolerance.

One process runs both packages (child clusterers are seeded from
``hash(child_id)``); the engines run on one torch thread
(tests/torch_engine_cases.py).
"""
import numpy as np
import pytest
import torch

from torch_engine_cases import ATOL, RTOL, one_torch_thread  # noqa: F401

ROUNDS = 30
# tests/conftest.py's ELASTIC_WIDTH: sharded runs pin their row blocks to
# the full width (300 clients / 60 participants -> 75 rows)
ELASTIC_WIDTH = 75
# tests/test_elastic_restore.py's MATRIX: (plane, round_overlap, save round)
MATRIX = [
    ("dense", 0, 6),
    ("dense", 0, 20),
    ("dense", 1, 6),
    ("dense", 1, 20),
    ("store", 0, 20),
    ("store", 1, 6),
    ("procedural", 0, 6),
    ("procedural", 1, 20),
]
POP = dict(n_clients=300, n_groups=4, group_sep=0.0, dirichlet=3.0, label_conflict=1.0)
AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=3, clustering_start_frac=0.03,
            min_members=6, margin_threshold=0.35)


def _population(plane, seed, package):
    if package == "jax":
        from repro.data import make_population
        from repro.data.plane import ProceduralDataPlane
    else:
        from repro_torch.data import ProceduralDataPlane, make_population
    if plane == "procedural":
        return ProceduralDataPlane(**POP, seed=seed)
    return make_population(**POP, seed=seed)


def scenario(seed=5, rounds=ROUNDS, plane="dense", partitions=True, package="torch", **fl_kw):
    """tests/conftest.py's elastic_scenario in either package:
    (task, population, fl, auxo)."""
    if package == "jax":
        from repro.fl import AuxoConfig, FLConfig
        from repro.fl.task import MLPTask
    else:
        from repro_torch.fl import AuxoConfig, FLConfig, MLPTask
    pop = _population(plane, seed, package)
    fl_kw.setdefault("population_store", plane == "store")
    if fl_kw.get("cohort_shards", 0) > 1:
        fl_kw.setdefault("rows_per_shard", ELASTIC_WIDTH)
    fl = FLConfig(rounds=rounds, participants_per_round=60, eval_every=rounds - 1,
                  use_availability=False, seed=seed, **fl_kw)
    auxo = AuxoConfig(**AUXO, partition_start_frac=0.08 if partitions else 2.0,
                      partition_end_frac=0.9 if partitions else 2.0)
    return MLPTask(dim=pop.dim, n_classes=pop.n_classes), pop, fl, auxo


def engine(*args, **kw):
    from repro_torch.fl import AuxoEngine

    return AuxoEngine(*scenario(*args, **kw), device="cpu")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def digest(eng, eval_round=None):
    """tests/conftest.py's engine_digest for either package: per-cohort bank
    params/opt/clocks by cohort id (slot ids depend on the layout), the
    affinity table in sorted-cohort-id column order, fingerprints, probe
    caches, the global mean, the leaves and, with ``eval_round``, the
    evaluation."""
    from repro_torch.utils.tree import leaves

    bank = eng.pipeline.bank
    out = {}
    for cid, slot in bank.slot_of.items():
        out[f"params:{cid}"] = np.concatenate([np.ravel(_np(v)) for v in leaves(bank.params_of(cid))])
        out[f"opt:{cid}"] = np.concatenate([np.ravel(_np(v)) for v in leaves(bank.opt_state_of(cid))])
        out[f"clock:{cid}"] = np.asarray([bank.clock[slot], float(bank.rounds[slot])])
    n = eng.data.n_clients
    ids = np.arange(n, dtype=np.int64)
    tbl = eng.pipeline.table
    rw, kn, cl = (tbl.reward, tbl.known, tbl.cluster_idx) if hasattr(tbl, "reward") else tbl.to_dense(n)
    slots = [bank.slot_of[c] for c in sorted(bank.slot_of)]
    out["table"] = np.concatenate([rw[:, slots].ravel(), kn[:, slots].ravel().astype(np.float32),
                                   cl[:, slots].ravel().astype(np.float32)])
    out["fp"] = np.concatenate([
        np.asarray(eng.fingerprint[ids]).ravel(),
        np.asarray(eng.fp_seen[ids]).astype(np.float32),
        np.asarray(eng.neg_streak[ids]).astype(np.float32),
    ])
    if isinstance(eng._probe_cache, dict):
        pids = np.sort(np.fromiter(eng._probe_cache.keys(), np.int64, len(eng._probe_cache)))
        out["probe:ids"] = pids
        if pids.size:
            out["probe:vals"] = np.stack([eng._probe_cache[int(c)] for c in pids])
    else:
        out["probe:fp"] = eng.store.to_dense("probe_fp", n)
        out["probe:seen"] = eng.store.to_dense("probe_seen", n)
    out["mu"] = np.asarray(eng.global_mu)
    out["leaves"] = np.frombuffer(",".join(eng.coordinator.tree.leaves()).encode(), np.uint8)
    if eval_round is not None:
        ev = eng.evaluate(eval_round)
        out["eval:per_client"] = np.asarray(ev["per_client"])
        out["eval:scalars"] = np.asarray([ev["acc_mean"], ev["acc_worst10"], ev["acc_best10"],
                                          ev["acc_var"], ev["time"], ev["resource"]])
    return out


def assert_digest_equal(da, db, ctx=""):
    assert set(da) == set(db), (ctx, set(da) ^ set(db))
    for key in sorted(da):
        assert np.array_equal(da[key], db[key]), (
            f"{ctx} digest mismatch at {key!r}: max|diff|="
            f"{np.max(np.abs(np.asarray(da[key], np.float64) - np.asarray(db[key], np.float64)))}"
        )


def run_continuous(k, rounds=ROUNDS, plane="dense", **fl_kw):
    """The comparator: one engine, pipeline flushed at round k (the save
    boundary) and at the end."""
    eng = engine(rounds=rounds, plane=plane, **fl_kw)
    for r in range(k):
        eng.step(r)
    eng.pipeline.flush()
    for r in range(k, rounds):
        eng.step(r)
    eng.pipeline.flush()
    return eng


def run_restored(k, ckpt, rounds=ROUNDS, plane="dense", load_kw=None, **fl_kw):
    """The subject: k rounds, save_run, load_run (optionally onto another
    shard count), continue to the end."""
    from repro_torch.checkpoint import load_run, save_run

    eng = engine(rounds=rounds, plane=plane, **fl_kw)
    for r in range(k):
        eng.step(r)
    save_run(ckpt, eng)
    eng = load_run(ckpt, device="cpu", **(load_kw or {}))
    assert eng.round_cursor == k
    for r in range(eng.round_cursor, rounds):
        eng.step(r)
    eng.pipeline.flush()
    return eng


@pytest.mark.parametrize("plane,overlap,k", MATRIX)
def test_restore_bit_equal(plane, overlap, k, tmp_path):
    a = run_continuous(k, plane=plane, round_overlap=overlap)
    b = run_restored(k, tmp_path / "ckpt", plane=plane, round_overlap=overlap)
    assert_digest_equal(digest(a, ROUNDS - 1), digest(b, ROUNDS - 1),
                        ctx=f"plane={plane} overlap={overlap} k={k}")
    # partitions really straddle the save point
    parts = [p.round_idx for p in a.coordinator.partitions]
    assert len(a.coordinator.tree.leaves()) >= 2, parts
    assert any(r >= k for r in parts) if k == 6 else any(r < k for r in parts), (k, parts)


def test_round_cursor_and_history_roundtrip(tmp_path):
    from repro_torch.checkpoint import load_run, save_run

    eng = engine(rounds=12)
    for r in range(5):
        eng.step(r)
    eng.history.append(eng.evaluate(4))
    save_run(tmp_path / "c", eng)
    back = load_run(tmp_path / "c", device="cpu")
    assert back.round_cursor == 5
    assert len(back.history) == 1
    h0, h1 = eng.history[0], back.history[0]
    np.testing.assert_array_equal(h0["per_client"], h1["per_client"])
    assert h0["acc_mean"] == h1["acc_mean"]
    assert h0["cohort_accs"] == h1["cohort_accs"]


def test_staged_plan_blocks_remesh(tmp_path):
    """A staged §⑤ plan is layout-bound: restoring it onto another shard
    count refuses; the same-layout restore re-stages it."""
    from repro_torch.checkpoint import load_run, save_run

    eng = engine(rounds=12, round_overlap=1, partitions=False)
    for r in range(4):
        eng.step(r)
    save_run(tmp_path / "c", eng)
    assert eng.pipeline._staged is not None  # the flush kept the staged plan
    with pytest.raises(ValueError, match="layout-bound"):
        load_run(tmp_path / "c", cohort_shards=2, device="cpu")
    back = load_run(tmp_path / "c", device="cpu")
    assert back.pipeline._staged is not None and back.pipeline._staged[1] is not None
    assert back.pipeline._staged[0] == back.round_cursor


def test_opaque_plane_requires_population(tmp_path):
    from repro_torch.checkpoint import load_run, save_run
    from repro_torch.data import FederatedClassification, make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    pop = make_population(n_clients=80, n_groups=2, seed=3)
    bare = FederatedClassification(
        clients=pop.clients, test_x=pop.test_x, test_y=pop.test_y,
        n_classes=pop.n_classes, dim=pop.dim, n_groups=pop.n_groups,
    )
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    fl = FLConfig(rounds=4, participants_per_round=20, use_availability=False, seed=3)
    eng = AuxoEngine(task, bare, fl, AuxoConfig(max_cohorts=2, clustering_start_frac=0.0),
                     device="cpu")
    eng.step(0)
    eng.step(1)
    save_run(tmp_path / "c", eng)
    with pytest.raises(ValueError, match="population"):
        load_run(tmp_path / "c", device="cpu")
    back = load_run(tmp_path / "c", population=bare, device="cpu")
    for e in (eng, back):
        e.pipeline.flush()
        e.step(2)
        e.pipeline.flush()
    assert_digest_equal(digest(eng), digest(back))


def test_remesh_2_to_4_and_down_to_1_bit_equal(tmp_path):
    """Saved at 2 shards, restored onto 4 and onto 1: each continues
    bit-equal to a run that lived at the target shard count throughout
    (tests/test_elastic_restore.py's remesh case, at K 8, R 24)."""
    from repro_torch.checkpoint import load_run

    K, R = 8, 24
    cont4 = run_continuous(K, rounds=R, cohort_shards=4)
    up = run_restored(K, tmp_path / "c", rounds=R, cohort_shards=2, load_kw={"cohort_shards": 4})
    assert up.pipeline.bank.n_shards == 4
    assert_digest_equal(digest(cont4, R - 1), digest(up, R - 1), ctx="2->4")
    down = load_run(tmp_path / "c", cohort_shards=1, device="cpu")
    assert down.pipeline.bank.n_shards == 1
    for r in range(down.round_cursor, R):
        down.step(r)
    down.pipeline.flush()
    cont1 = run_continuous(K, rounds=R, cohort_shards=0, rows_per_shard=ELASTIC_WIDTH)
    assert_digest_equal(digest(cont1, R - 1), digest(down, R - 1), ctx="2->1")
    assert len(up.coordinator.tree.leaves()) >= 2
    assert up.pipeline.dropped_rows == 0 and up.pipeline.exec_dispatches == R


# ----------------------------------------------- across the two packages
CROSS_K, CROSS_R = 6, 12  # the whole-run tolerance holds over 12 rounds


def _assert_close_runs(ja, tb):
    """Same partitions, leaves, slots and per-client cluster indices; bank
    params within the whole-run tolerance, cohort by cohort."""
    from torch_engine_cases import host_state, partitions

    assert partitions(ja) == partitions(tb)
    assert ja.coordinator.tree.leaves() == tb.coordinator.tree.leaves()
    jb, tbk = ja.pipeline.bank, tb.pipeline.bank
    assert sorted(jb.slot_of) == sorted(tbk.slot_of)
    n = ja.data.n_clients
    ci = [jb.slot_of[c] for c in sorted(jb.slot_of)]
    ct = [tbk.slot_of[c] for c in sorted(tbk.slot_of)]
    np.testing.assert_array_equal(host_state(ja, n)["cluster_idx"][:, ci],
                                  host_state(tb, n)["cluster_idx"][:, ct])
    for cid, slot in jb.slot_of.items():
        got = tbk.params_of(cid)
        for k, v in jb.params.items():
            np.testing.assert_allclose(_np(got[k]), np.asarray(v)[slot], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{cid}/{k}")


def _jax_engine(**kw):
    from repro.fl import AuxoEngine

    return AuxoEngine(*scenario(rounds=CROSS_R, package="jax", **kw))


# the overlap case saves after round 7: after round 6 the drain retires a
# partition and drops the staged plan
@pytest.mark.parametrize("shards,overlap,k", [(1, 0, CROSS_K), (2, 0, CROSS_K), (1, 1, 7)])
def test_jax_checkpoint_continues_in_the_port(shards, overlap, k, tmp_path):
    """The JAX package's save_run at one device, loaded by the port at 1 and
    2 shards (and with a staged §⑤ plan, re-staged from its host buffers)
    and continued: the JAX run's own continuation within the whole-run
    tolerance."""
    from repro.checkpoint import save_run as jsave
    from repro_torch.checkpoint import load_run

    je = _jax_engine(round_overlap=overlap)
    for r in range(k):
        je.step(r)
    jsave(tmp_path / "c", je)
    # at 2 shards the automatic block width is the full width (75): no drops
    te = load_run(tmp_path / "c", cohort_shards=shards, device="cpu")
    assert te.round_cursor == k and te.pipeline.bank.n_shards == shards
    assert (te.pipeline._staged is not None and te.pipeline._staged[1] is not None) == bool(overlap)
    for r in range(k, CROSS_R):
        je.step(r)
        te.step(r)
    je.pipeline.flush()
    te.pipeline.flush()
    assert len(je.coordinator.partitions) >= 1
    _assert_close_runs(je, te)
    assert te.pipeline.dropped_rows == 0


def test_port_checkpoint_continues_in_jax(tmp_path):
    """The port's save_run loaded by the JAX package with task= and
    continued: the port run's own continuation within the tolerance."""
    from repro.checkpoint import load_run as jload
    from repro.fl.task import MLPTask as JTask
    from repro_torch.checkpoint import save_run
    from torch_engine_cases import init_of

    je0 = _jax_engine()  # the same initial weights in both packages
    from repro_torch.fl import AuxoEngine

    te = AuxoEngine(*scenario(rounds=CROSS_R), device="cpu", init_params=init_of(je0))
    for r in range(CROSS_K):
        te.step(r)
    save_run(tmp_path / "c", te)
    je = jload(tmp_path / "c", task=JTask(dim=te.task.dim, n_classes=te.task.n_classes))
    assert je.round_cursor == CROSS_K
    for r in range(CROSS_K, CROSS_R):
        te.step(r)
        je.step(r)
    je.pipeline.flush()
    te.pipeline.flush()
    assert len(te.coordinator.partitions) >= 1
    _assert_close_runs(je, te)


def test_store_and_data_plane_files_cross_between_the_packages(tmp_path):
    """save/load_population_store and save/load_data_plane: each package
    reads the other's files to the same store state and the same data."""
    from repro.checkpoint import npz as jnpz
    from repro_torch.checkpoint import npz as tnpz
    from repro_torch.data import as_plane

    te = engine(rounds=6, plane="store")
    for r in range(3):
        te.step(r)
    tnpz.save_population_store(tmp_path / "t_store.npz", te.store)
    js = jnpz.load_population_store(tmp_path / "t_store.npz")
    jnpz.save_population_store(tmp_path / "j_store.npz", js)
    back = tnpz.load_population_store(tmp_path / "j_store.npz")
    n = te.data.n_clients
    for name in te.store.field_names:
        a = te.store.to_dense(name, n)
        np.testing.assert_array_equal(np.asarray(js.to_dense(name, n)), a, err_msg=name)
        np.testing.assert_array_equal(back.to_dense(name, n), a, err_msg=name)
    for plane in ("dense", "procedural"):
        tp = scenario(plane=plane)[1]
        tnpz.save_data_plane(tmp_path / f"t_{plane}.npz", as_plane(tp))
        jp = jnpz.load_data_plane(tmp_path / f"t_{plane}.npz")
        jnpz.save_data_plane(tmp_path / f"j_{plane}.npz", jp)
        back = tnpz.load_data_plane(tmp_path / f"j_{plane}.npz")
        ids = np.arange(0, 300, 7)
        np.testing.assert_array_equal(np.asarray(jp.client_sizes(ids)), back.client_sizes(ids))
        xj, yj = jp.probe_batches(ids, 8, 2)
        xt, yt = back.probe_batches(ids, 8, 2)
        np.testing.assert_array_equal(np.asarray(xj), xt)
        np.testing.assert_array_equal(np.asarray(yj), yt)
