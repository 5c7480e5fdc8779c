#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, as CI on the card runs it
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only

Phases (any failure exits non-zero; no phase catches an error and goes on):
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  3. kernel vs plain version on the card, over the JAX kernel tests' shape
     sweep and the main-path shapes, f32 and bf16, with a cohort axis;
  4. the main path: ``run_auxo`` on the openimage-like population with the
     paper benchmarks' settings; every kernel must have launched;
  5. determinism: a second run from the same seed is bit-identical;
  6. timing at the main-path shapes (CUDA events, median of >= 20 runs).
The last two lines are a JSON kernel report and the JSON result line.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

# tests/test_kernels.py SHAPES (P, D, K) plus the main-path shapes
SWEEP = [(1, 128, 2), (7, 33, 3), (128, 512, 8), (200, 300, 5), (1024, 256, 16),
         (64, 64, 64), (512, 128, 4), (64, 128, 2), (125, 6922, 7), (125, 1, 7),
         (64, 1, 2), (0, 128, 2), (33, 128, 1)]
TOL = {"f32": (2e-5, 2e-5, 2e-5), "bf16": (2e-2, 5e-2, 5e-2)}  # cos, seg, seg-weighted


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def check_kernels(torch, ops, ref, cs, sa) -> float:
    """Phase 3: every kernel against its plain version on the card."""
    worst = {"cosine_similarity": 0.0, "segment_aggregate": 0.0}
    g = torch.Generator(device="cuda").manual_seed(0)
    for (P, D, K) in SWEEP:
        for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tcos, tseg, tsegw = TOL[dname]
            for C in (None, 3):
                lead = () if C is None else (C,)
                x = torch.randn(lead + (P, D), generator=g, device="cuda").to(dt)
                c = torch.randn(lead + (K, D), generator=g, device="cuda").to(dt)
                if P > 1:  # a zero row must give similarity 0
                    x[..., 0, :] = 0
                got = ops.cosine_similarity(x, c)
                want = ref.cosine_similarity(x, c)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item() if got.numel() else 0.0
                if not torch.allclose(got, want, rtol=tcos, atol=tcos):
                    raise AssertionError(f"cosine {dname} C={C} {(P, D, K)}: max err {err}")
                worst["cosine_similarity"] = max(worst["cosine_similarity"], err)
                # ids in [-1, K]: -1 and K are padding and must be dropped
                ids = torch.randint(-1, K + 1, lead + (P,), generator=g, device="cuda")
                for weighted in (False, True):
                    w = (torch.rand(lead + (P,), generator=g, device="cuda")
                         if weighted else None)
                    got = ops.segment_aggregate(x, ids, K, w)
                    want = ref.segment_aggregate(x, ids, K, w)
                    torch.cuda.synchronize()
                    tol = tsegw if weighted else tseg
                    err = (got - want).abs().max().item() if got.numel() else 0.0
                    if not torch.allclose(got, want, rtol=tol, atol=tol):
                        raise AssertionError(
                            f"segment {dname} C={C} w={weighted} {(P, D, K)}: max err {err}")
                    worst["segment_aggregate"] = max(worst["segment_aggregate"], err)
    # run-to-run bit-identity of the fixed-order reductions
    x = torch.randn(1, 125, 6922, generator=g, device="cuda")
    ids = torch.randint(0, 7, (1, 125), generator=g, device="cuda")
    w = torch.rand(1, 125, generator=g, device="cuda")
    a = ops.segment_aggregate(x, ids, 7, w)
    b = ops.segment_aggregate(x, ids, 7, w)
    if not torch.equal(a, b):
        raise AssertionError("segment_aggregate is not run-to-run identical")
    # a CUDA tensor never falls back: wrong inputs raise
    for bad in (lambda: cs.cosine_similarity(x.double(), x.double()),
                lambda: sa.segment_aggregate(x, ids.long(), 7)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise AssertionError("a kernel wrapper accepted inputs it does not take")
    return worst




# ------------------------------------------------------------ the main path
# benchmarks/common.py: the "openimage-like" population (1000 clients,
# 4 latent groups) with default_fl / default_auxo, written out here
POP = dict(seed=1, n_clients=1000, n_groups=4, group_sep=0.0, dirichlet=2.0,
           label_conflict=0.6)
AUXO = dict(d_sketch=128, cluster_k=2, max_cohorts=4, clustering_start_frac=0.03,
            partition_start_frac=0.08, partition_end_frac=0.7, min_members=10,
            margin_threshold=0.5)
ROUNDS = 40
TIMED_SHAPES = 6  # distinct call shapes timed per kernel, largest first
# examples/quickstart.py scaled to 120 clients / 12 rounds (tests/test_torch_round.py)
SMALL_POP = dict(n_clients=120, n_groups=2, group_sep=0.0, dirichlet=2.0,
                 label_conflict=0.6, seed=0)
SMALL_FL = dict(rounds=12, participants_per_round=40, eval_every=4, seed=0,
                use_availability=False)
SMALL_AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=2, clustering_start_frac=0.05,
                  partition_start_frac=0.1, min_members=8)


def run_main(torch, rounds: int):
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, FLConfig, MLPTask, run_auxo

    pop = make_population(**POP)
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    fl = FLConfig(rounds=rounds, participants_per_round=100,
                  eval_every=max(2, rounds // 20), use_availability=True, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, hist = run_auxo(task, pop, fl, AuxoConfig(**AUXO), device="cuda")
    torch.cuda.synchronize()
    return eng, hist, time.perf_counter() - t0


def bank_digest(eng):
    bank = eng.pipeline.bank
    flat = {f"p/{k}": v for k, v in bank.params.items()}
    for g, tree in bank.opt_state.items():
        flat.update({f"o/{g}/{k}": v for k, v in tree.items()})
    parts = [(e.parent, tuple(e.children), e.round_idx) for e in eng.coordinator.partitions]
    return parts, flat


def small_reference(torch):
    """A small run on the card against the same run on the CPU (the plain
    kernel versions): same partitions and leaf composition, close params."""
    from repro_torch import random as rnd
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    task = MLPTask(dim=32, n_classes=10)
    init = {k: v.numpy() for k, v in task.init(rnd.key(0)).items()}
    engs = {}
    for dev in ("cuda", "cpu"):
        e = AuxoEngine(task, make_population(**SMALL_POP), FLConfig(**SMALL_FL),
                       AuxoConfig(**SMALL_AUXO), device=dev, init_params=init)
        e.run()
        engs[dev] = e
    g, c = engs["cuda"], engs["cpu"]
    pg, fg = bank_digest(g)
    pc, fc = bank_digest(c)
    if not pg or pg != pc:
        raise AssertionError(f"small run: partitions differ card {pg} vs CPU {pc}")
    if g.serving_cohorts() != c.serving_cohorts():
        raise AssertionError("small run: leaf composition differs between card and CPU")
    err = max((fg[k].cpu() - fc[k]).abs().max().item() for k in fg)
    for k in fg:
        if not torch.allclose(fg[k].cpu(), fc[k], rtol=1e-4, atol=1e-5):
            raise AssertionError(f"small run: {k} differs card vs CPU (max {err})")
    return pg, err


# ------------------------------------------------------------------ timing
def graph_ms(torch, fn, inner: int = 20, reps: int = 25) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events; the median per call."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def eager_ms(torch, fn, inner: int = 20, reps: int = 25) -> float:
    """Stream time of one eager call, launch path included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def bound(nbytes: float, flops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_cosine(torch, ops, ref, sig):
    (xs, cs_shape, dt) = sig
    x = torch.randn(xs, device="cuda").to(dt)
    c = torch.randn(cs_shape, device="cuda").to(dt)
    C, P, D = xs
    K = cs_shape[1]
    el = x.element_size()
    nbytes = C * (P * D + K * D) * el + C * P * K * 4
    flops = C * (2 * P * K * D + 2 * P * D + 2 * K * D)
    F = torch.nn.functional
    lib = lambda: F.cosine_similarity(x.unsqueeze(-2), c.unsqueeze(-3), dim=-1)  # noqa: E731
    return dict(
        ms=graph_ms(torch, lambda: ops.cosine_similarity(x, c)),
        eager_ms=eager_ms(torch, lambda: ops.cosine_similarity(x, c)),
        plain_ms=graph_ms(torch, lambda: ref.cosine_similarity(x, c)),
        library_ms=graph_ms(torch, lib),
        bound=bound(nbytes, flops),
    )


def time_segment(torch, ops, ref, sig):
    (ds, K, dt, weighted) = sig
    data = torch.randn(ds, device="cuda").to(dt)
    lead = ds[:-1]
    ids = torch.randint(0, K, lead, device="cuda")
    w = torch.rand(lead, device="cuda") if weighted else None
    n_rows = int(((ids >= 0) & (ids < K)).sum())  # rows this data sums
    C, P, D = ds
    el = data.element_size()
    nbytes = C * P * D * el + C * P * 4 * (2 if weighted else 1) + C * K * D * 4
    flops = n_rows * D * (2 if weighted else 1)
    library_ms = None
    if not weighted and C == 1:  # one call computes the unweighted sum
        out = torch.zeros(K, D, device="cuda")
        library_ms = graph_ms(torch, lambda: out.index_add_(0, ids[0], data[0]))
    return dict(
        ms=graph_ms(torch, lambda: ops.segment_aggregate(data, ids, K, w)),
        eager_ms=eager_ms(torch, lambda: ops.segment_aggregate(data, ids, K, w)),
        plain_ms=graph_ms(torch, lambda: ref.segment_aggregate(data, ids, K, w)),
        library_ms=library_ms,
        bound=bound(nbytes, flops),
    )


def record(mod, name, sig, log):
    """Log each call's shape signature (the wrapper's own count is untouched)."""
    orig = getattr(mod, name)

    def rec(*a, **k):
        key = sig(*a, **k)
        log[key] = log.get(key, 0) + 1
        return orig(*a, **k)

    setattr(mod, name, rec)
    return lambda: setattr(mod, name, orig)


def profile_rounds(torch, eng, start: int, n: int) -> str:
    """Kernel time by name over n more rounds, and the device's busy share:
    device time under the profiler over the wall of n unprofiled rounds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(start, start + n):
        eng.step(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in range(start + n, start + 2 * n):
            eng.step(r)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    dev = sum(e.self_device_time_total for e in evs if e.device_type == DeviceType.CUDA) / 1e6
    table = evs.table(sort_by="self_device_time_total", row_limit=12)
    return (f"{table}\n[profile] {n} rounds (steps only): wall {wall:.4f} s unprofiled, "
            f"device busy {dev:.6f} s under the profiler = {100 * dev / wall:.2f}% of the wall")


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this check runs only on the card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"the port package is missing under {SRC}")
    sys.path.insert(0, SRC)

    # ---------------------------------------------------------- phase 1
    card = smi()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {card}")

    # ---------------------------------------------------------- phase 2
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    so = build.build()
    print(f"[build] {so} in {time.perf_counter() - t0:.2f} s")
    if build.build_log:
        print(build.build_log)
    build.library()

    # ---------------------------------------------------------- phase 3
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_aggregate as sa
    worst = check_kernels(torch, ops, ref, cs, sa)
    print(f"[kernels] kernel vs plain max |err|: {worst} "
          f"(tolerances f32 2e-5, bf16 2e-2 cosine / 5e-2 segment)")
    result = {"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}
    if "--kernels-only" in argv:
        print(card)
        print(json.dumps(result))
        return 0

    # ------------------------------------ phase 4a: small run, card vs CPU
    parts, err = small_reference(torch)
    print(f"[reference] 120-client run: card == CPU partitions {parts}, "
          f"bank max |diff| {err:.3e} (rtol 1e-4, atol 1e-5)")

    # ----------------------------------------------- phase 4: main path
    shapes = {"cosine_similarity": {}, "segment_aggregate": {}}
    undo = [
        record(cs, "cosine_similarity",
               lambda x, c, eps=1e-8: (tuple(x.shape), tuple(c.shape), x.dtype),
               shapes["cosine_similarity"]),
        record(sa, "segment_aggregate",
               lambda d, i, k, w=None: (tuple(d.shape), int(k), d.dtype, w is not None),
               shapes["segment_aggregate"]),
    ]
    cs.launches = 0
    sa.launches = 0
    eng, hist, secs = run_main(torch, ROUNDS)
    launches = {"cosine_similarity": cs.launches, "segment_aggregate": sa.launches}
    for u in undo:
        u()
    n_leaves = len(eng.coordinator.tree.leaves())
    accs = [h["acc_mean"] for h in hist]
    print(f"[main] run_auxo openimage-like, {ROUNDS} rounds: {secs:.3f} s "
          f"({secs / ROUNDS:.4f} s/round, evaluation every {max(2, ROUNDS // 20)} rounds "
          f"included); host stage seconds {eng.pipeline.stage_seconds}")
    print(f"[main] n_cohorts {[h['n_cohorts'] for h in hist]}")
    print(f"[main] acc_mean {[round(a, 4) for a in accs]}")
    print(f"[main] partitions {[(e.parent, e.round_idx) for e in eng.coordinator.partitions]}; "
          f"kernel launches {launches}")
    for k, v in shapes.items():
        print(f"[main] {k} call shapes: {v}")
    if min(launches.values()) <= 0:
        return fail(f"a kernel of the main path never launched: {launches}")
    finite = all(bool(torch.isfinite(v).all()) for v in eng.pipeline.bank.params.values())
    if not finite or not all(a == a and 0.0 <= a <= 1.0 for a in accs):
        return fail("non-finite bank params or accuracies")
    if n_leaves < 2:
        return fail(f"only {n_leaves} leaf cohort(s) formed")
    if accs[-1] < 0.5:
        return fail(f"final acc_mean {accs[-1]} is below 0.5")

    # ------------------------------------------------- phase 5: determinism
    eng2, hist2, secs2 = run_main(torch, ROUNDS)
    p1, b1 = bank_digest(eng)
    p2, b2 = bank_digest(eng2)
    if p1 != p2 or [h["acc_mean"] for h in hist2] != accs:
        return fail(f"second run differs: partitions {p1} vs {p2}")
    same = [k for k in b1 if not torch.equal(b1[k], b2[k])]
    if same:
        return fail(f"second run's bank is not bit-identical at {same}")
    print(f"[determinism] second run: identical partitions and bit-identical bank "
          f"({secs2 / ROUNDS:.4f} s/round)")
    if "--profile" in argv:
        print(profile_rounds(torch, eng2, ROUNDS, 5))

    # ------------------------------------------------------ phase 6: timing
    report = []
    meta = {
        "cosine_similarity": ("src/repro_torch/kernels/csrc/cosine_sim.cu",
                              "src/repro/kernels/cosine_sim.py:46", time_cosine),
        "segment_aggregate": ("src/repro_torch/kernels/csrc/segment_aggregate.cu",
                              "src/repro/kernels/segment_aggregate.py:46", time_segment),
    }
    for name, (source, replaces, timer) in meta.items():
        # the call with the most bytes represents the kernel in the report
        sigs = sorted(shapes[name], key=lambda s: -int(torch.Size(s[0]).numel()))
        rows = []
        for sig in sigs[:TIMED_SHAPES]:
            t = timer(torch, ops, ref, sig)
            rows.append((sig, t))
            print(f"[timing] {name} {sig} x{shapes[name][sig]} per main run: kernel "
                  f"{t['ms']:.5f} ms (eager {t['eager_ms']:.5f}), plain {t['plain_ms']:.5f}, "
                  f"library {t['library_ms']}, bound {t['bound'][0]:.6f} ms ({t['bound'][1]})")
        sig, t = rows[0]
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "shape": repr(sig), "eager_ms": t["eager_ms"],
        })
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
