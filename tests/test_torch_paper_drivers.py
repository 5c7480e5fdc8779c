"""The paper's drivers (``repro_torch.paper``) against the JAX package's
(``benchmarks/``): the pure helpers on synthetic histories, Tables 3 and 4,
Figure 10 (FTFA included), Figure 12 and the roofline table, each run()
at the cut of tests/torch_paper_cases.py in both packages, in one process
(child clusterers are seeded from ``hash(child_id)``). Table 5 and
Figures 13 and 14 have files of their own (their sweeps take longer)."""
import json

import numpy as np
import pytest

import benchmarks.common as jcommon
import repro_torch.paper.common as tcommon
from torch_engine_cases import jax_compile_cache, one_torch_thread  # noqa: F401 (fixtures)
from torch_paper_cases import ROUNDS, assert_histories_match, assert_rows_match, cut

# synthetic histories: a baseline that peaks mid-run, runs that reach its
# peak earlier, later, never, and a baseline that never reaches its own
# target (impossible for real histories; the helpers still agree)
_H = lambda accs, dt=10.0: [{"acc_mean": a, "time": dt * (i + 1)} for i, a in enumerate(accs)]  # noqa: E731
HISTORIES = {
    "base": _H([0.2, 0.5, 0.7, 0.65]),
    "fast": _H([0.3, 0.71, 0.8, 0.9], dt=7.0),
    "slow": _H([0.1, 0.2, 0.4, 0.72], dt=12.5),
    "never": _H([0.1, 0.2, 0.3, 0.4]),
    "flat": _H([0.5, 0.5, 0.5, 0.5]),
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
@pytest.mark.parametrize("target", [0.0, 0.4, 0.7, 0.95])
def test_time_to_accuracy_and_speedup(name, target):
    h = HISTORIES[name]
    assert tcommon.time_to_accuracy(h, target) == jcommon.time_to_accuracy(h, target)
    for base in HISTORIES.values():
        assert tcommon.tta_speedup(base, h) == jcommon.tta_speedup(base, h)


def test_emit_prints_the_same_csv(capsys):
    rows = [dict(dataset="a", speedup=1.23456789, n=3), dict(dataset="b", extra=float("nan"), speedup=0.5),
            dict(n=np.int64(4), speedup=float("inf"))]
    for emit in (jcommon.emit, tcommon.emit):
        emit(rows, "Table X")
        emit([], "empty")
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "== Table X ==\ndataset,speedup,n,extra\na,1.2346,3,\n" in out


def test_scenarios_and_defaults_are_the_reference_s():
    assert tcommon.SCENARIOS == jcommon.SCENARIOS
    for rounds in (12, 40, 100):
        jf, tf = jcommon.default_fl(rounds, dp_sigma=0.5), tcommon.default_fl(rounds, dp_sigma=0.5)
        ja, ta = jcommon.default_auxo(rounds, max_cohorts=8), tcommon.default_auxo(rounds, max_cohorts=8)
        for j, t in ((jf, tf), (ja, ta)):
            jd, td = vars(j), vars(t)
            assert {k: jd[k] for k in jd if k in td} == {k: td[k] for k in jd if k in td}
    jt, jp = jcommon.build("speech-like")
    tt, tp = tcommon.build("speech-like")
    assert (jt.dim, jt.n_classes, jt.hidden, jt.depth) == (tt.dim, tt.n_classes, tt.hidden, tt.depth)
    for a, b in zip(jp.clients, tp.clients):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)


def test_table3(monkeypatch, jax_compile_cache):
    from benchmarks import table3_tta as J
    from repro_torch.paper import table3_tta as T

    runs = cut(monkeypatch, J, T)
    jrows = J.run(ROUNDS, scenarios=["openimage-like", "reddit-like"])
    trows = T.run(ROUNDS, scenarios=["openimage-like", "reddit-like"], device="cpu")
    assert_rows_match(jrows, trows)
    assert all(r["n_cohorts"] >= 2 for r in trows)
    assert_histories_match(runs["jax"], runs["port"])


def test_table4(monkeypatch, jax_compile_cache):
    from benchmarks import table4_bias as J
    from repro_torch.paper import table4_bias as T

    runs = cut(monkeypatch, J, T)
    jrows = J.run(ROUNDS, scenarios=["femnist-like"])
    trows = T.run(ROUNDS, scenarios=["femnist-like"], device="cpu")
    assert [r["setting"] for r in trows] == ["auxo", "baseline"]
    assert_rows_match(jrows, trows)
    assert_histories_match(runs["jax"], runs["port"])


def test_fig10_algorithms_and_ftfa(monkeypatch, jax_compile_cache):
    from benchmarks import fig10_algorithms as J
    from repro_torch.paper import fig10_algorithms as T

    runs = cut(monkeypatch, J, T)
    jrows = J.run(ROUNDS)
    trows = T.run(ROUNDS, device="cpu")
    assert [r["algorithm"] for r in trows] == ["fedyogi", "fedavg", "fedprox", "qfedavg"]
    assert "ftfa_auxo" in trows[0] and all("ftfa_auxo" not in r for r in trows[1:])
    assert_rows_match(jrows, trows)
    assert_histories_match(runs["jax"], runs["port"])


def test_fig12_correlation(monkeypatch, jax_compile_cache):
    """Row by row on the cut openimage-like population (the driver's 150
    probed clients are the whole population); the engine's training rng is
    in the same state after the run (the probe batches are drawn from it
    where the reference draws them)."""
    from benchmarks import fig12_correlation as J
    from repro_torch.paper import fig12_correlation as T

    cut(monkeypatch, J, T)
    engines = {}
    for pkg, mod in (("jax", J), ("port", T)):
        cls = mod.AuxoEngine

        class Recorded(cls):
            def __init__(self, *a, _pkg=pkg, **kw):
                super().__init__(*a, **kw)
                engines[_pkg] = self

        monkeypatch.setattr(mod, "AuxoEngine", Recorded)
    jrows = J.run(ROUNDS)
    trows = T.run(ROUNDS, device="cpu")
    assert [r["round"] for r in trows] == [r["round"] for r in jrows] == list(range(ROUNDS))
    # sketches of 150 near-identical deltas (the params within rtol 1e-4):
    # the correlation over their 11,175 pairs is held at 1e-4
    for a, b in zip(jrows, trows):
        assert list(a) == list(b)
        assert abs(a["pearson_r"] - b["pearson_r"]) <= 1e-4, (a, b)
    assert engines["port"].rng.bit_generator.state == engines["jax"].rng.bit_generator.state
    assert engines["port"].sketcher.strategy == engines["jax"].sketcher.strategy == "last_block_proj"


def _artifact(arch, shape, mesh="16x16", tag="", **over):
    d = {"arch": arch, "shape": shape, "mesh": mesh, "policy": "tp", "tag": tag, "useful_flops_ratio": 0.4567,
         "roofline": {"compute_s": 0.0123, "memory_s": 0.0456, "collective_s": 0.00078, "bottleneck": "memory"},
         "memory": {"step_peak_bytes": 3.5e9, "plan_bytes": 7e10}}
    d.update(over)
    return d


def test_roofline_render_and_run(tmp_path, monkeypatch, capsys):
    from repro_torch.paper import roofline

    arts = [_artifact("granite-3-2b", "train_4k"), _artifact("qwen3-8b", "decode_32k", policy="fsdp"),
            _artifact("granite-3-2b", "prefill_32k", tag="sweep"),
            _artifact("xlstm-1.3b", "train_4k", memory={"plan_bytes": 1.0})]
    del arts[3]["useful_flops_ratio"], arts[3]["policy"]
    for i, a in enumerate(arts):
        (tmp_path / f"{i}.json").write_text(json.dumps(a))
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path)
    rows = roofline.load()
    assert sorted(r["arch"] for r in rows) == ["granite-3-2b", "qwen3-8b", "xlstm-1.3b"]
    assert [r["shape"] for r in roofline.load("sweep")] == ["prefill_32k"]
    table = roofline.render(rows).splitlines()
    assert table[0].startswith("| arch | shape | mesh | policy | compute (ms)")
    assert table[2] == "| granite-3-2b | train_4k | 16x16 | tp | 12.30 | 45.60 | 0.78 | memory | 0.46 | 3.50 |"
    assert table[3] == "| qwen3-8b | decode_32k | 16x16 | fsdp | 12.30 | 45.60 | 0.78 | memory | 0.46 | 3.50 |"
    # keys a port artifact may lack render as "-"
    assert table[4] == "| xlstm-1.3b | train_4k | 16x16 | - | 12.30 | 45.60 | 0.78 | memory | - | - |"
    out = roofline.run()
    assert capsys.readouterr().out.startswith("| arch | shape")
    assert out[0] == dict(arch="granite-3-2b", shape="train_4k", mesh="16x16", compute_ms=12.3,
                          memory_ms=45.6, collective_ms=0.78, bottleneck="memory")
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path / "none")
    assert roofline.run() == []
    assert "repro_torch.launch.dryrun --all" in capsys.readouterr().out


def test_roofline_reads_the_port_s_dry_run_keys(tmp_path, monkeypatch):
    """The keys the table renders are the ones launch.dryrun writes: one
    real plan (granite-3-2b's decode at a mini width) through render."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.paper import roofline

    try:
        rep = dryrun.lower_one("granite-3-2b", "decode_32k", False, probes=False,
                               cfg_overrides=dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
                                                  d_ff=128, vocab=256))
    finally:  # the plan's fake process group stays out of later tests in this process
        if dist.is_initialized():
            dist.destroy_process_group()
    (tmp_path / "a.json").write_text(json.dumps(rep, default=str))
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path)
    line = roofline.render(roofline.load()).splitlines()[2]
    assert "-" not in line.replace("granite-3-2b", "").replace("decode_32k", "").split("|")[4:], line
