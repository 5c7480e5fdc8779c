"""Cohort-aware serving on the card: batched decode against per-cohort
models (the PyTorch port's ``examples/serve_cohorts.py``).

After Auxo training produces K cohort models, serving routes each request to
its cohort's model (the request carries the client's affinity record) and
decodes with the production serve_step (KV cache, one token per call). The
first tokens are the JAX example's: the same threefry draws.

Runs on the card unless ``--device cpu`` is given; ``--steps`` shortens the
run.

  PYTHONPATH=src python examples/port_serve_cohorts.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.steps import StepConfig, make_serve_step
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_config(get_config("qwen3-8b")).replace(d_model=256, vocab=1024)
    model = build_model(cfg)
    sc = StepConfig()
    serve = make_serve_step(model, sc)

    key = rnd.key(0, device=dev)
    # two cohort models (e.g. after an Auxo partition)
    cohort_models = {
        "0.0": model.init(rnd.fold_in(key, 0), device=dev),
        "0.1": model.init(rnd.fold_in(key, 1), device=dev),
    }

    B, steps, max_seq = 8, args.steps, 128
    requests = [("0.0" if i % 2 == 0 else "0.1") for i in range(B * 2)]

    # batch requests per cohort (the cohort coordinator's serving-side match)
    tokens = {}
    for cohort, params in cohort_models.items():
        batch_ids = [i for i, c in enumerate(requests) if c == cohort][:B]
        cache = model.init_cache(len(batch_ids), max_seq, device=dev)
        tok = rnd.randint(key, (len(batch_ids), 1), 0, cfg.vocab)
        t0 = time.time()
        out = []
        for t in range(steps):
            logits, cache = serve(params, cache, {"tokens": tok})
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out.append(tok[:, 0].cpu().numpy())
        dt = time.time() - t0
        tokens[cohort] = np.stack(out)
        print(
            f"cohort {cohort}: decoded {steps} tokens for {len(batch_ids)} requests "
            f"in {dt*1e3:.0f} ms ({steps*len(batch_ids)/dt:.0f} tok/s); "
            f"sample: {tokens[cohort][:6, 0].tolist()}"
        )
    return tokens


if __name__ == "__main__":
    main()
