"""Roofline aggregation: reads the port's dry-run artifacts
(``experiments/dryrun_h100/*.json``, written by ``python -m
repro_torch.launch.dryrun``) and renders the per-(arch × shape) roofline
table (markdown + CSV), a port of ``benchmarks/roofline.py``.

The port's artifacts plan memory without XLA's buffer assignment, so the
last column reads the step's own peak beyond its state and inputs
(``memory.step_peak_bytes``) where the reference reads XLA's temp
allocation. A key an artifact lacks renders as "-".
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List

DRYRUN_DIR = Path("experiments/dryrun_h100")


def load(tag_filter: str = "") -> List[dict]:
    rows = []
    for f in sorted(DRYRUN_DIR.glob("*.json")):
        d = json.loads(f.read_text())
        if tag_filter and d.get("tag") != tag_filter:
            continue
        if not tag_filter and d.get("tag"):
            continue  # default view = untagged baselines
        rows.append(d)
    return rows


def _cell(d: dict, *path, fmt="{}", scale=1.0) -> str:
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return "-"
        d = d[k]
    return fmt.format(d * scale) if scale != 1.0 else fmt.format(d)


def render(rows: List[dict]) -> str:
    hdr = (
        "| arch | shape | mesh | policy | compute (ms) | memory (ms) | "
        "collective (ms) | bottleneck | MODEL/HLO flops | step peak GB/dev |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for d in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {_cell(d, 'policy')} "
            f"| {_cell(d, 'roofline', 'compute_s', fmt='{:.2f}', scale=1e3)} "
            f"| {_cell(d, 'roofline', 'memory_s', fmt='{:.2f}', scale=1e3)} "
            f"| {_cell(d, 'roofline', 'collective_s', fmt='{:.2f}', scale=1e3)} "
            f"| {_cell(d, 'roofline', 'bottleneck')} "
            f"| {_cell(d, 'useful_flops_ratio', fmt='{:.2f}')} "
            f"| {_cell(d, 'memory', 'step_peak_bytes', fmt='{:.2f}', scale=1e-9)} |"
        )
    return hdr + "\n".join(lines)


def run():
    rows = load()
    if not rows:
        print("no dry-run artifacts found — run: python -m repro_torch.launch.dryrun --all")
        return []
    print(render(rows))
    out = []
    for d in rows:
        r = d["roofline"]
        out.append(
            dict(
                arch=d["arch"], shape=d["shape"], mesh=d["mesh"],
                compute_ms=r["compute_s"] * 1e3, memory_ms=r["memory_s"] * 1e3,
                collective_ms=r["collective_s"] * 1e3, bottleneck=r["bottleneck"],
            )
        )
    return out


if __name__ == "__main__":
    run()
