"""Collective-traffic profile of one (arch × shape) on the production mesh
(port of ``repro.launch.profile``).

Runs the dry run's SPMD probe of ``--units`` repeating units (the step as
one program over the 16 × 16 mesh of the fake process group, every tensor
fake, nothing allocated on a card) and prints one card's collective bytes
by op and its largest collectives: which tensors dominate the traffic
between cards.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen3-moe-235b-a22b --shape train_4k --top 20

``--mesh 2x2`` and ``--set k=v`` (config overrides, as the dry run's) size
the probe down for a quick look.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import FSDP_ARCHS, _with_units, fake_device, parse_overrides, probe_step
from repro_torch.launch.mesh import init_fake_world, make_mesh
from repro_torch.launch.specs import TRAIN_CLIENTS, effective_config, flat_batch_specs, input_specs
from repro_torch.launch.steps import StepConfig
from repro_torch.utils.hlo import collective_bytes, top_collectives


def profile(arch: str, shape_name: str, units: int = 2, policy: Optional[str] = None, top: int = 20,
            mesh_shape=(16, 16), overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The SPMD probe of ``units`` repeating units of (arch, shape) on a
    (data, model) mesh of the fake process group: one card's records, its
    bytes by op (``collective_bytes``) and the ``top`` rows."""
    cfg0 = get_config(arch)
    shape = SHAPES[shape_name]
    cfg = effective_config(cfg0, shape).replace(dtype=torch.bfloat16, **(overrides or {}))
    cfg = _with_units(cfg, units)
    policy = policy or ("fsdp" if cfg0.arch_id in FSDP_ARCHS else "tp")
    central = shape.kind == "train" and policy == "fsdp"
    batch = flat_batch_specs(cfg, shape) if central else input_specs(cfg, shape.name)
    init_fake_world(mesh_shape[0] * mesh_shape[1])
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), fake_device())
    t0 = time.time()
    counts = probe_step(cfg, shape.kind, batch, StepConfig(), central, TRAIN_CLIENTS,
                        cache_len=shape.seq_len, mesh=mesh, policy=policy)
    return {"arch": arch, "shape": shape_name, "units": units, "policy": policy,
            "mesh": "x".join(str(n) for n in mesh_shape), "records": counts.collectives,
            "by_op": collective_bytes(counts.collectives), "top": top_collectives(counts.collectives, top),
            "step_peak_bytes": counts.step_peak_bytes, "seconds": time.time() - t0}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--mesh", default="16x16", help="data x model, on the fake process group")
    ap.add_argument("--set", action="append", default=[], help="config overrides, e.g. --set d_model=256")
    args = ap.parse_args(argv)

    rep = profile(args.arch, args.shape, args.units, args.policy, args.top,
                  tuple(int(n) for n in args.mesh.split("x")), parse_overrides(args.set))
    print(f"== {args.arch} × {args.shape} ({args.units} units, {rep['policy']}, {rep['mesh']} mesh, "
          f"{len(rep['records'])} collectives, {rep['seconds']:.1f}s) ==")
    print("per-card collective bytes by op:")
    for k, v in rep["by_op"].items():
        print(f"  {k:20s} {v / 1e9:8.3f} GB")
    print(f"\ntop {args.top} collectives (total-bytes, count, bytes-each, op, shape):")
    for tot, cnt, b, op, sh in rep["top"]:
        print(f"  {tot / 1e9:8.3f} GB  x{cnt:<4d} {b / 1e6:9.2f} MB  {op:20s} {sh}")
    return rep


if __name__ == "__main__":
    main()
