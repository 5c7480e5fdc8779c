"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic mix (``perfbench/traffic/<mix>.json``),
whose ``entry`` names the driver in ``perfbench/entries/``, each metric's
reader in ``perfbench/metrics/`` and the cell's limits in
``perfbench/limits/``. The program under test is ``repro_torch`` in the
checkout's ``src/``.

A run: set-up (the weights made on the card from the seed, the program
built, warmed up and driven through the steps its check follows), then,
with ``--trace 1``, whole steps under ``torch.profiler``, then the window:
whole steps back to back until ``--seconds`` have passed (the step that
crosses the deadline finishes). Then the peak memory is read, the
program's state freed, and its outputs judged against the plain reference.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. The last lines on standard error, and
the result's last key, give each number compared beside its limit.

Exits with 2, printing no result, without a CUDA card (or fewer than the
cell asks for), and with 3 if JAX or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "perfbench-cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        config: dict = None, fault: str = None, chips_check: bool = True, limits: dict = None) -> dict:
    """One run of a cell; returns the result dict (``print_result`` prints
    it). Tests pass ``device="cpu"``, a small ``config`` with its own
    ``limits``, and ``fault``."""
    import torch

    from perfbench.lib import manifest, trace as tracing

    man = manifest.load()
    wl = manifest.workload(man, workload)
    if chips_check and (not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]):
        raise NoCard(f"{workload} needs {wl['chips']} CUDA card(s); "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    cfg = config or manifest.config(man, wl["config"])
    tr = manifest.traffic(wl["traffic"])
    entry = manifest.entry(tr["entry"])
    ctx = types.SimpleNamespace(config=cfg, traffic=tr, seed=int(seed), device=torch.device(device),
                                trace=bool(trace), fault=fault, workload=workload)
    cell = entry.setup(ctx)
    setup_s = time.perf_counter() - T0
    build = sys.modules.get("repro_torch.kernels.build")
    if getattr(build, "build_log", None):  # this run built the kernels: ptxas's report
        print(build.build_log, file=sys.stderr)
    traced = {}
    if trace:
        traced = tracing.profile(lambda: [cell.step() for _ in range(tr["trace_steps"])])
    cell.window = True
    steps, work = 0, 0.0
    t0 = time.perf_counter()
    if seconds > 0:
        while True:
            work += cell.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    cell.window = False
    rec = cell.finish()
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded after the window: {found}")
    rec.update(config=cfg, traffic=tr, workload=workload, setup_s=setup_s, window_s=window_s,
               steps=steps, work=work, memory_peak_bytes=peak, trace=traced)
    metrics = {}
    for m in manifest.metrics_of(man, workload, bool(trace)):
        value = manifest.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.close()
    limits = limits or manifest.limits(workload)
    checks, error = {}, None
    try:  # the reference runs now, after the program's state is freed
        values = cell.check()
        checks = {k: {"value": float(values[k]), "limit": float(limits[k])} for k in limits}
    except Exception as e:  # a check that cannot be made is not correct
        error = f"{type(e).__name__}: {e}"
    del cell
    correct = (error is None and rec["failed"] == 0
               and all(checks[k]["value"] <= checks[k]["limit"] for k in checks))
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                   "kind": torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu",
                   "count": wl["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": rec.get("attempted", steps), "failed": rec["failed"],
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = traced.get("busy_s", 0.0)
        device_info["window_s"] = traced.get("window_s", 0.0)
        if traced.get("breakdown"):
            out["breakdown"] = traced["breakdown"]
    if error:
        out["error"] = error
    out["checks"] = checks
    return out


class NoCard(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def print_result(out: dict):
    if "error" in out:
        print(f"check failed to run: {out['error']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except Forbidden as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
