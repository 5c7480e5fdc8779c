"""Cohort placement of the port (``repro_torch.launch.mesh`` /
``launch.sharding``, the sharded CohortBank and its collective-free round)
against the JAX package.

The JAX package's own sharded runs need fake host devices in a subprocess,
and under jax 0.9.0 they stop at their first partition
(``CohortBank.spawn_children``'s scatter on the sharded slot axis raises
``ShardingTypeError``). So the port's sharded runs are held against the
reference's single-device runs and its block-packing rules:

- the slot algebra against ``repro.launch.sharding``, with
  tests/test_remesh_repack.py's three properties;
- ``plan_round``'s block packing against the JAX package's plan_round run
  on the same tables with its pipeline set to the same shard layout;
- the C = 32 scenario of tests/test_cohort_sharding.py at 8 shards, DP
  noise on, against the JAX package's single-device run;
- organic runs at 2, 4 and 8 shards with the full row width, and at 4
  shards over two device groups, bit-equal to the port's single-device
  run (each segment sums its rows in row order wherever its block sits).

All shards are CPU shards; one process, one torch thread.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from torch_engine_cases import (  # noqa: F401
    ATOL, RTOL, MODES_AUXO, MODES_FL, MODES_POP, init_of, one_torch_thread,
    partitions, port_engine,
)
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import cohort_size, make_cohort_mesh


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# --------------------------------------------------------------- slot algebra
GRID = [(cap, s) for cap in (1, 5, 15, 63, 127) for s in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("cap,s", GRID)
def test_slot_algebra_matches_jax(cap, s):
    from repro.launch import sharding as jsh

    assert tsh.padded_capacity(cap, s) == jsh.padded_capacity(cap, s)
    full = tsh.padded_capacity(cap, s)
    for n in sorted({0, 1, full // 2, full}):
        np.testing.assert_array_equal(tsh.alloc_slots(n, cap, s), jsh.alloc_slots(n, cap, s))
        for b in (1, 2, 4):
            n_b = min(n, tsh.padded_capacity(cap, b))
            for mine, ref in zip(tsh.repack_permutation(n_b, cap, s, b),
                                 jsh.repack_permutation(n_b, cap, s, b)):
                np.testing.assert_array_equal(mine, ref)
    # gather / scatter / repack on the same payload
    rng = np.random.default_rng(cap * 10 + s)
    tree = {"w": rng.normal(size=(full, 3)).astype(np.float32),
            "o": {"m": rng.integers(-5, 5, size=(full,)).astype(np.int32)}}
    n = full // 2 + 1 if full > 1 else full
    slots = tsh.alloc_slots(n, cap, s)
    g_t, g_j = tsh.gather_allocations(tree, slots), jsh.gather_allocations(tree, slots)
    np.testing.assert_array_equal(g_t["w"], np.asarray(g_j["w"]))
    np.testing.assert_array_equal(g_t["o"]["m"], np.asarray(g_j["o"]["m"]))
    zeros = {"w": np.zeros_like(tree["w"]), "o": {"m": np.zeros_like(tree["o"]["m"])}}
    sc_t = tsh.scatter_allocations({k: torch.from_numpy(v) if k == "w" else
                                    {"m": torch.from_numpy(v["m"])} for k, v in zeros.items()},
                                   g_t, slots)
    sc_j = jsh.scatter_allocations(zeros, g_j, slots)
    np.testing.assert_array_equal(_np(sc_t["w"]), np.asarray(sc_j["w"]))
    np.testing.assert_array_equal(_np(sc_t["o"]["m"]), np.asarray(sc_j["o"]["m"]))
    for b in (1, 2, 4):
        n_b = min(n, tsh.padded_capacity(cap, b))
        r_t = tsh.repack_stacked(tree, cap, n_b, s, b)
        r_j = jsh.repack_stacked(tree, cap, n_b, s, b)
        np.testing.assert_array_equal(_np(r_t["w"]), np.asarray(r_j["w"]))
        np.testing.assert_array_equal(_np(r_t["o"]["m"]), np.asarray(r_j["o"]["m"]))


# tests/test_remesh_repack.py's properties, on the port's functions
capacities = st.integers(min_value=1, max_value=96)
shard_counts = st.integers(min_value=1, max_value=12)


@given(cap=capacities, s=shard_counts)
@settings(max_examples=60, deadline=None)
def test_alloc_slots_is_a_permutation(cap, s):
    n = tsh.padded_capacity(cap, s)
    slots = tsh.alloc_slots(n, cap, s)
    assert slots.shape == (n,)
    assert slots.min() >= 0 and slots.max() < n
    assert np.unique(slots).size == n
    np.testing.assert_array_equal(slots, tsh.alloc_slots(n, n, s))


@given(cap=capacities, s=shard_counts, data=st.data())
@settings(max_examples=60, deadline=None)
def test_alloc_slots_partial_is_injective_and_prefix_stable(cap, s, data):
    n_max = tsh.padded_capacity(cap, s)
    n = data.draw(st.integers(min_value=0, max_value=n_max), label="n_alloc")
    slots = tsh.alloc_slots(n, cap, s)
    assert np.unique(slots).size == n
    np.testing.assert_array_equal(slots, tsh.alloc_slots(n_max, cap, s)[:n])


@given(cap=capacities, a=shard_counts, b=shard_counts, data=st.data())
@settings(max_examples=60, deadline=None)
def test_repack_round_trips_and_preserves_values(cap, a, b, data):
    n_max = min(tsh.padded_capacity(cap, a), tsh.padded_capacity(cap, b))
    n = data.draw(st.integers(min_value=0, max_value=n_max), label="n_alloc")
    old_slots, new_slots = tsh.repack_permutation(n, cap, a, b)
    cap_a = tsh.padded_capacity(cap, a)
    tree = {"w": torch.zeros((cap_a, 2)), "c": torch.zeros((cap_a,), dtype=torch.int32)}
    tree["w"][old_slots] = torch.arange(1, n + 1, dtype=torch.float32)[:, None]
    tree["c"][old_slots] = torch.arange(1, n + 1, dtype=torch.int32)
    moved = tsh.repack_stacked(tree, cap, n, a, b)
    assert moved["w"].shape == (tsh.padded_capacity(cap, b), 2)
    for k in ("w", "c"):
        np.testing.assert_array_equal(tsh.gather_allocations(moved, new_slots)[k],
                                      tsh.gather_allocations(tree, old_slots)[k])
    assert float(moved["w"].abs().sum()) == float(tree["w"].abs().sum())
    back = tsh.repack_stacked(moved, cap, n, b, a)
    assert torch.equal(back["w"], tree["w"]) and torch.equal(back["c"], tree["c"])


# ------------------------------------------------------ mesh and the bank
def test_cpu_mesh_and_placement():
    mesh = make_cohort_mesh(4, device="cpu")
    assert cohort_size(mesh) == 4 == mesh.n_shards and cohort_size(None) == 1
    assert set(mesh.devices) == {torch.device("cpu")}
    groups = tsh.shard_groups(mesh)
    assert groups == [tsh.ShardGroup(torch.device("cpu"), (0, 1, 2, 3))]
    # an explicit list: shards alternate over two devices -> two groups
    mesh2 = make_cohort_mesh(4, devices=["cpu", "cpu:0", "cpu", "cpu:0", "cpu"])
    g2 = tsh.shard_groups(mesh2)
    assert [g.shards for g in g2] == [(0, 2), (1, 3)]
    np.testing.assert_array_equal(tsh.bank_placement(g2, 3)[1], [3, 4, 5, 9, 10, 11])
    np.testing.assert_array_equal(tsh.row_placement(g2, 2)[0], [0, 1, 4, 5])
    with pytest.raises(ValueError, match="devices"):
        make_cohort_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        make_cohort_mesh(0, device="cpu")


def test_bank_capacity_padding_and_interleaved_allocation():
    """tests/test_cohort_sharding.py's allocation case on a real 8-shard
    bank: capacity 15 pads to 16, allocation is round-robin over the shard
    blocks, and the bank's slots follow ``alloc_slots``."""
    from repro_torch.fl.pipeline import CohortBank

    params = {"w": torch.ones(3)}
    opt = {"m": {"w": torch.zeros(3)}}
    bank = CohortBank(params, opt, capacity=15)
    assert bank.capacity == 15 and bank.slots_per_shard == 15 and bank.n_shards == 1
    bank = CohortBank(params, opt, capacity=15, mesh=make_cohort_mesh(8, device="cpu"))
    assert bank.capacity == 16 and bank.slots_per_shard == 2
    order = [bank._alloc_slot(n) for n in range(16)]
    assert order == [0, 2, 4, 6, 8, 10, 12, 14, 1, 3, 5, 7, 9, 11, 13, 15]
    np.testing.assert_array_equal(order, tsh.alloc_slots(16, 15, 8))
    assert [bank.shard_of(s) for s in order[:8]] == list(range(8))
    assert bank.params["w"].shape == (16, 3) and torch.equal(bank.params["w"][0], torch.ones(3))
    children = [f"0.{i}" for i in range(7)]
    slots = bank.spawn_children("0", children)
    assert slots == order[1:8]
    for c in children:  # warm-started from the parent across the blocks
        assert torch.equal(bank.params_of(c)["w"], torch.ones(3))
        assert torch.equal(bank.opt_state_of(c)["m"]["w"], torch.zeros(3))
    with pytest.raises(RuntimeError, match="exhausted"):
        bank.spawn_children("0.0", [f"x{i}" for i in range(9)])


# ------------------------------------------------------- sharded plans
def force_leaves(eng, n_leaves):
    """benchmarks/round_latency.py's force_leaves for the port: grow the
    tree to ``n_leaves`` by unconditional binary partitions."""
    from repro_torch.core.clustering import OnlineClustering
    from repro_torch.core.coordinator import CohortStats, PartitionEvent

    co = eng.coordinator
    while len(co.tree.leaves()) < n_leaves:
        leaf = co.tree.leaves()[0]
        children = co.tree.partition(leaf, co.cluster_k)
        for ch in children:
            co.clusterers[ch] = OnlineClustering(co.cluster_k, co.d_sketch,
                                                 seed=co.seed + hash(ch) % 10_000, device=co.device)
            co.stats[ch] = CohortStats()
        event = PartitionEvent(parent=leaf, children=children, round_idx=0,
                               cluster_to_child={i: ch for i, ch in enumerate(children)})
        eng.pipeline.bank.spawn_children(event.parent, event.children)
        eng.pipeline.table.seed_children(eng.pipeline.bank.slot_of[event.parent],
                                         [eng.pipeline.bank.slot_of[ch] for ch in event.children])
        co.partitions.append(event)


class _LayoutBank:
    """The slot layout of a sharded bank, for the JAX package's plan_round
    (which reads only these)."""

    def __init__(self, bank):
        self.slot_of = dict(bank.slot_of)
        self.capacity = bank.capacity
        self.slots_per_shard = bank.slots_per_shard

    def shard_of(self, slot):
        return slot // self.slots_per_shard


PLAN_POP = dict(n_clients=200, n_groups=4, group_sep=0.0, dirichlet=2.0, label_conflict=0.6, seed=11)
PLAN_FL = dict(rounds=10, participants_per_round=40, use_availability=False, seed=11)
PLAN_AUXO = dict(d_sketch=16, cluster_k=2, max_cohorts=8, clustering_start_frac=0.0,
                 partition_start_frac=2.0, partition_end_frac=2.0)
PLAN_FIELDS = ("slot_rows", "client_rows", "real", "kept", "claimed", "sizes", "update_slots", "order")


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("leaves,rows", [(3, 0), (8, 0), (8, 4)])
def test_sharded_plans_follow_the_reference_packing(shards, leaves, rows):
    """The port's plan_round at S shards (automatic block width, or 4 rows a
    block, under the quota of 6) against the JAX package's plan_round on the same tables, with
    its pipeline set to the same layout: the same rows, slots, clients,
    canonical order, drops, and empty blocks padded with their shard's
    first slot."""
    from repro.data import make_population as jmake
    from repro.fl.pipeline import AffinityTable as JTable
    from repro_torch.data import make_population

    te = port_engine(make_population(**PLAN_POP), PLAN_FL, PLAN_AUXO, cohort_shards=shards,
                     rows_per_shard=rows)
    from torch_engine_cases import jax_engine

    je = jax_engine(jmake(**PLAN_POP), PLAN_FL, PLAN_AUXO)
    force_leaves(te, leaves)
    for ev in te.coordinator.partitions:  # the same tree in the JAX coordinator
        je.coordinator.tree.partition(ev.parent, je.coordinator.cluster_k)
    tp, jp = te.pipeline, je.pipeline
    jp.n_shards, jp.shard_width, jp.exec_width = tp.n_shards, tp.shard_width, tp.exec_width
    jp.bank = _LayoutBank(tp.bank)
    jp.table = JTable(200, tp.bank.capacity)
    # the same skewed affinities in both: exploiting clients crowd some
    # cohorts, so blocks fill (drops) and others stay empty
    rng = np.random.default_rng(shards * 100 + leaves + rows)
    slots = [tp.bank.slot_of[l] for l in te.coordinator.tree.leaves()]
    for t in (tp.table, jp.table):
        t.known[:] = False
    known = rng.random((200, len(slots))) < 0.7
    reward = (rng.random((200, len(slots))) * np.linspace(1.0, 0.2, len(slots))).astype(np.float32)
    for t in (tp.table, jp.table):
        t.known[:, slots] = known
        t.reward[:, slots] = reward
    drops = empties = 0
    for r in range(6):
        a, b = tp.plan_round(r), jp.plan_round(r)
        assert a.active == b.active and a.leaves == b.leaves
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"round {r} {f}")
        assert (a.n_real, a.dropped, a.key_seed) == (b.n_real, b.dropped, b.key_seed)
        W, sps = tp.shard_width, tp.bank.slots_per_shard
        for j in range(shards):  # every row of block j references shard j's slots
            assert np.all(a.slot_rows[j * W:(j + 1) * W] // sps == j)
            empties += int(not a.real[j * W:(j + 1) * W].any())
        drops += a.dropped
    assert tp.dropped_rows == jp.dropped_rows == drops
    if rows:
        assert drops > 0
    if leaves < shards:
        assert empties > 0


# ------------------------------------------------ sharded runs, end to end
C32_POP = dict(n_clients=800, n_groups=8, group_sep=0.0, dirichlet=2.0, label_conflict=0.6, seed=13)
C32_FL = dict(rounds=4, participants_per_round=128, use_availability=False, seed=13,
              dp_clip=1.0, dp_sigma=0.1)
C32_AUXO = dict(d_sketch=32, cluster_k=2, max_cohorts=32, clustering_start_frac=0.0,
                partition_start_frac=2.0, partition_end_frac=2.0)


def test_c32_at_8_shards_matches_the_jax_single_device_run():
    """tests/test_cohort_sharding.py's C = 32 scenario with DP noise on: the
    port at 8 CPU shards (capacity 64, 8 slots and 40 rows a shard) against
    the JAX package's single-device run from the same weights. The noise
    keys follow the canonical order (``inv``), so a row's noise is its
    participant's wherever the row sits."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    from repro.data import make_population as jmake
    from round_latency import force_leaves as jforce
    from repro_torch.data import make_population
    from torch_engine_cases import jax_engine

    je = jax_engine(jmake(**C32_POP), C32_FL, C32_AUXO)
    jforce(je, 32)
    te = port_engine(make_population(**C32_POP), C32_FL, C32_AUXO, init=init_of(je), cohort_shards=8)
    force_leaves(te, 32)
    p = te.pipeline
    assert (p.bank.capacity, p.bank.slots_per_shard, p.shard_width, p.exec_width) == (64, 8, 40, 320)
    for r in range(3):
        je.step(r)
        te.step(r)
    assert p.exec_dispatches == 3 and p.dropped_rows == 0
    leaves = je.coordinator.tree.leaves()
    assert leaves == te.coordinator.tree.leaves() and len(leaves) == 32
    for cid in leaves:
        got, want = te.pipeline.bank.params_of(cid), je.pipeline.bank.params_of(cid)
        for k, v in want.items():
            np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{cid}/{k}")


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu:0", "cpu", "cpu:0"]], ids=["one-group", "two-groups"])
def test_spawn_across_blocks_after_the_first_step(devices):
    """The reference's ``probe`` case: a step, then a partition whose children
    land in other shard blocks (other device groups too), then more steps.
    The children start from the parent's slot, and the run stays bit-equal
    to the single-device run that spawns the same children."""
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    def run(**kw):
        pop = make_population(**{**C32_POP, "n_clients": 200})
        fl = FLConfig(**{**C32_FL, "participants_per_round": 40}, **kw)
        eng = AuxoEngine(MLPTask(dim=pop.dim, n_classes=pop.n_classes), pop, fl,
                         AuxoConfig(**C32_AUXO), device="cpu",
                         devices=devices if kw.get("cohort_shards") else None)
        eng.step(0)
        bank = eng.pipeline.bank
        force_leaves(eng, 2)  # "0" -> "0.0", "0.1"
        kids = [bank.slot_of[ch] for ch in ("0.0", "0.1")]
        for ch in ("0.0", "0.1"):
            for k, v in bank.params_of("0").items():
                assert torch.equal(bank.params_of(ch)[k], v)
        for r in (1, 2, 3):
            eng.step(r)
        return eng, kids

    single, _ = run()
    sharded, kids = run(cohort_shards=4, rows_per_shard=single.pipeline.width)
    bank = sharded.pipeline.bank
    assert len(bank.groups) == (1 if devices is None else 2)
    assert sorted({bank.shard_of(s) for s in kids} | {0}) == [0, 1, 2]  # children in blocks 1 and 2
    assert single.pipeline.bank.slot_of != bank.slot_of
    for cid in ("0", "0.0", "0.1"):
        for k, v in single.pipeline.bank.params_of(cid).items():
            assert torch.equal(bank.params_of(cid)[k], v), (cid, k)
    assert sharded.pipeline.exec_dispatches == 4


@pytest.mark.parametrize("shards,devices", [(2, None), (4, None), (8, None),
                                            (4, ["cpu", "cpu:0", "cpu", "cpu:0"])],
                         ids=["S2", "S4", "S8", "S4-two-groups"])
def test_organic_sharded_run_is_the_single_device_run(shards, devices):
    """tests/test_pipeline.py's 30-round scenario (two organic partitions)
    at S shards with the full row width (75): partitions, leaves and every
    cohort's bank, tables and fingerprints bit-equal to the single-device
    run. Each segment adds its rows in row order wherever its block sits,
    and a row's training does not depend on the rows beside it."""
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    pop = make_population(**MODES_POP)
    single = port_engine(pop, MODES_FL, MODES_AUXO)
    sharded = AuxoEngine(MLPTask(dim=pop.dim, n_classes=pop.n_classes), pop,
                         FLConfig(**MODES_FL, cohort_shards=shards, rows_per_shard=75),
                         AuxoConfig(**MODES_AUXO), device="cpu", devices=devices)
    for e in (single, sharded):
        for r in range(MODES_FL["rounds"]):
            e.step(r)
        e.pipeline.flush()
    assert len(partitions(single)) == 2 and partitions(single) == partitions(sharded)
    assert single.coordinator.tree.leaves() == sharded.coordinator.tree.leaves()
    sb, tb = single.pipeline.bank, sharded.pipeline.bank
    for cid in sb.slot_of:
        for k, v in sb.params_of(cid).items():
            assert torch.equal(tb.params_of(cid)[k], v), (cid, k)
        for g, tree in sb.opt_state_of(cid).items():
            for k, v in tree.items():
                assert torch.equal(tb.opt_state_of(cid)[g][k], v), (cid, g, k)
    cols_s = [sb.slot_of[c] for c in sorted(sb.slot_of)]
    cols_t = [tb.slot_of[c] for c in sorted(tb.slot_of)]
    for name in ("reward", "known", "cluster_idx"):
        np.testing.assert_array_equal(getattr(single.pipeline.table, name)[:, cols_s],
                                      getattr(sharded.pipeline.table, name)[:, cols_t])
    np.testing.assert_array_equal(single.fingerprint, sharded.fingerprint)
    # a partition put children in other shards than their parent
    ev = sharded.coordinator.partitions[0]
    assert {tb.shard_of(tb.slot_of[c]) for c in ev.children} != {tb.shard_of(tb.slot_of[ev.parent])}
    assert sharded.pipeline.exec_dispatches == MODES_FL["rounds"] and sharded.pipeline.dropped_rows == 0
    # the serving snapshot is the (capacity, ...) bank
    assert sharded.pipeline.serve_params["w0"].shape[0] == tb.capacity


def test_automatic_block_width_drops_and_still_trains():
    """The automatic block width (2·width/S = 38 rows at S = 4) drops
    participants of crowded blocks; dropped_rows counts them and the run
    still partitions."""
    from repro_torch.data import make_population

    eng = port_engine(make_population(**MODES_POP), MODES_FL, MODES_AUXO, cohort_shards=4)
    assert eng.pipeline.shard_width == 38 and eng.pipeline.exec_width == 152
    for r in range(12):
        eng.step(r)
    assert eng.pipeline.dropped_rows > 0
    assert eng.pipeline.exec_dispatches == 12
    assert all(torch.isfinite(v).all() for v in eng.pipeline.bank.params.values())
