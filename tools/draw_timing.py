"""Times the port's threefry draws on the card, for one or more copies of
the package, so that a change and its parent are timed in one call.

    python3 tools/draw_timing.py [--src DIR ...] [--reps N]

Each ``--src DIR`` (default: this checkout's ``src``) is imported in a
process of its own, in the order given (list the parent and the change as
parent, change, change, parent). Rows, each timed by CUDA events (the
median of ``--reps`` calls after two warm-up calls):

- ``sketch_block``: one of the sketch's projection blocks,
  ``rademacher(fold_in(key, i), (2**16, 256))`` (``core.sketch``);
- ``normal_block``: ``normal`` of the same 2**24 values (an init leaf of
  one chunk);
- ``trunc_normal_2^26``: ``truncated_normal`` of (4096, 16384) float32,
  the fan-in init of a leaf of four chunks.

Prints one JSON line per copy and the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(reps: int) -> dict:
    import torch

    from repro_torch import random as rnd

    key = rnd.key(1234 * 7919, device="cuda")
    rows = {
        "sketch_block": lambda: rnd.rademacher(rnd.fold_in(key, 3), (1 << 16, 256)),
        "normal_block": lambda: rnd.normal(key, (1 << 16, 256)),
        "trunc_normal_2^26": lambda: rnd.truncated_normal(key, -2.0, 2.0, (4096, 16384)),
    }
    out = {}
    for name, fn in rows.items():
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        r = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before - r.numel() * r.element_size()
        out[name] = {"ms": statistics.median(times), "min_ms": min(times), "extra_bytes": extra}
        del r
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", help="a copy's src directory (repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("draw_timing: no CUDA card", file=sys.stderr)
        return 1
    for src in args.src or [os.path.join(ROOT, "src")]:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--reps", str(args.reps)],
                             env=env, capture_output=True, text=True, check=True)
        print(json.dumps({"src": src, "rows": json.loads(res.stdout.strip().splitlines()[-1])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
