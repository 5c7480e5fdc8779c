"""Entry point of the paper's drivers on the port: one module per paper
table/figure.

  PYTHONPATH=src python -m repro_torch.paper.run                 # smoke pass, on the card
  PYTHONPATH=src python -m repro_torch.paper.run --full          # paper-scale rounds
  PYTHONPATH=src python -m repro_torch.paper.run --only table3_tta
  PYTHONPATH=src python -m repro_torch.paper.run --device cpu    # without a card

Every module prints a CSV block; roofline reads experiments/dryrun_h100/*.json
produced by repro_torch.launch.dryrun. The reference's kernels_micro suite
is a performance benchmark and has no port here.
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="paper-scale rounds")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the drivers run (default: the card; raises without CUDA)")
    args = ap.parse_args()
    if args.only == "kernels_micro":
        raise SystemExit("kernels_micro is a performance benchmark: the port's benchmark work "
                         "times the kernels; it is not one of the paper's drivers")

    rounds = 120 if args.full else 60
    from repro_torch.paper import (
        fig10_algorithms,
        fig12_correlation,
        fig13_sensitivity,
        fig14_resilience,
        roofline,
        table3_tta,
        table4_bias,
        table5_clustered_fl,
    )

    dev = args.device
    suites = {
        "table3_tta": lambda: table3_tta.run(
            rounds, scenarios=None if args.full else ["openimage-like", "femnist-like", "reddit-like"],
            device=dev,
        ),
        "fig10_algorithms": lambda: fig10_algorithms.run(rounds, device=dev),
        "table4_bias": lambda: table4_bias.run(
            rounds, scenarios=None if args.full else ["openimage-like", "femnist-like"], device=dev
        ),
        "table5_clustered_fl": lambda: table5_clustered_fl.run(max(40, rounds // 2), device=dev),
        "fig12_correlation": lambda: fig12_correlation.run(max(40, rounds // 2), device=dev),
        "fig13_sensitivity": lambda: fig13_sensitivity.run(max(40, rounds // 2), device=dev),
        "fig14_resilience": lambda: fig14_resilience.run(max(40, rounds // 2), device=dev),
        "roofline": lambda: roofline.run(),
    }
    if args.only:
        suites = {args.only: suites[args.only]}

    for name, fn in suites.items():
        t0 = time.time()
        fn()
        print(f"[{name}: {time.time()-t0:.0f}s]", flush=True)


if __name__ == "__main__":
    main()
