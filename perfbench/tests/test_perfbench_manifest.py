"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import os
import re

import pytest

from perfbench.lib import manifest

NAME, UNIT = manifest.NAME, manifest.UNIT
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in man["paths"])
    assert 1 <= len(man["command"]) <= 32 and not any(w.startswith("/") for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in man["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len(set(names)) == len(names)


def test_entry_keys(man):
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in man["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in man["workloads"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_files_found_by_name(man):
    for c in man["configs"]:
        assert c["file"].startswith("perfbench/") and manifest.config(man, c["name"])
    for w in man["workloads"]:
        tr = manifest.traffic(w["traffic"])
        assert os.path.exists(os.path.join(manifest.BENCH, "entries", tr["entry"] + ".py"))
        assert manifest.limits(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_every_cell_reports_what_it_must(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in man["workloads"]:
        mine = [m["name"] for m in manifest.metrics_of(man, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2
        assert manifest.metrics_of(man, w["name"], True)
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # a cell the metric lists reports what it moves
            assert cell in {w["name"] for w in man["workloads"]}
            assert m["moves"] in [x["name"] for x in manifest.metrics_of(man, cell, False)]


def test_one_layer_name_per_layer(man):
    layers = {m["layer"] for m in man["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    with open(os.path.join(manifest.ROOT, "PERF.md")) as f:
        perf = f.read()
    assert all(f"`{x}`" in perf for x in layers)


def test_check_budget(man):
    """A full check of 24 cells at run_seconds fits the driver's 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
