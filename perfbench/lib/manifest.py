"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``perfbench/configs/<config>.json`` (the manifest's ``file``)
- a traffic mix: ``perfbench/traffic/<traffic>.json``; its ``entry`` names
  the driver ``perfbench/entries/<entry>.py``
- a metric: its reader ``perfbench/metrics/<name>.py``
- a cell's limits on the numbers that decide ``correct``:
  ``perfbench/limits/<workload>.json``
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(workload_name: str) -> Dict[str, float]:
    return _json("limits", f"{workload_name}.json")


def _module(kind: str, name: str) -> ModuleType:
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str) -> ModuleType:
    return _module("entries", name)


def reader(metric: str) -> ModuleType:
    return _module("metrics", metric)


def metrics_of(man: dict, workload_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1): those that list the cell, or list no cells."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if workload_name in m.get("workloads", [workload_name])]
