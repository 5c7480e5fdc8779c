"""The port's collective bytes for the mini granite train step beside the
JAX package's, as a ratio (reported, not gated: the two partitioners, XLA's
GSPMD and DTensor's sharding propagation, may choose different programs).

    PYTHONPATH=src python tools/spmd_ratio.py [--top K]

The step is ``tests/test_dryrun_mini.py``'s: reduced granite-3-2b (d_model
256, 8 heads, 4 kv heads, bf16, query and CE chunks of 8) under ``tp`` on a
(4, 4) mesh, 8 clients x 4 sequences x 32 tokens, ``d_sketch`` 32, with the
layers unrolled in the reference (a ``lax.scan`` body would count once).
The reference compiles on 16 forced host devices in a subprocess; the port
runs its SPMD probe on the fake process group. Both on the CPU. It prints
the bytes by op side by side, then each side's top K collectives
(``top_collectives``: total bytes, count, bytes each, op, shape).
"""
import argparse
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

REF = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import json
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_config
    from repro.launch import sharding as shd
    from repro.launch.steps import StepConfig, clustering_init, yogi_init, make_train_step
    from repro.models import build_model
    from repro.utils import hlo

    mesh = jax.make_mesh((4, 4), ("data", "model"))
    cfg = reduce_config(get_config("granite_3_2b")).replace(
        dtype=jnp.bfloat16, d_model=256, n_heads=8, n_kv_heads=4, attn_qchunk=8, ce_chunk=8, unroll=True)
    model = build_model(cfg)
    pshapes = model.init_shapes()
    pshard = shd.param_shardings(pshapes, mesh, "tp")
    batch = {"tokens": jax.ShapeDtypeStruct((8, 4, 32), jnp.int32)}
    clust = jax.eval_shape(lambda: clustering_init(2, 32))
    opt = jax.eval_shape(lambda: yogi_init(pshapes))
    oshard = {k: shd.param_shardings(v, mesh, "fsdp") for k, v in opt.items()}
    cshard = jax.tree.map(lambda _: shd.replicated(mesh), clust)
    with mesh:
        compiled = jax.jit(make_train_step(model, StepConfig(d_sketch=32)),
                           in_shardings=(pshard, oshard, cshard, shd.batch_shardings(batch, mesh)),
                           out_shardings=(pshard, oshard, cshard, None)).lower(pshapes, opt, clust, batch).compile()
    text = compiled.as_text()
    print("RESULT " + json.dumps({"n_layers": cfg.n_layers, "bytes": hlo.collective_bytes(text),
                                  "top": hlo.top_collectives(text, 1000)}))
    """
)


def port_bytes(n_layers: int):
    import torch

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.specs import SDS
    from repro_torch.launch.steps import StepConfig
    from repro_torch.utils import hlo

    cfg = reduce_config(get_config("granite_3_2b")).replace(
        dtype=torch.bfloat16, d_model=256, n_heads=8, n_kv_heads=4, attn_qchunk=8, ce_chunk=8, n_layers=n_layers)
    lmesh.init_fake_world(16)
    mesh = lmesh.make_mesh((4, 4), ("data", "model"), dryrun.fake_device())
    counts = dryrun.probe_step(cfg, "train", {"tokens": SDS((8, 4, 32), torch.int32)}, StepConfig(d_sketch=32),
                               mesh=mesh, policy="tp")
    return hlo.collective_bytes(counts.collectives), hlo.top_collectives(counts.collectives, 1000)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=1800)
    if proc.returncode:
        sys.exit(proc.stderr[-3000:])
    ref = json.loads([l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1][7:])
    port, port_top = port_bytes(ref["n_layers"])
    print(f"mini granite-3-2b federated train step, tp, (4, 4) mesh, {ref['n_layers']} layers: "
          "per-card collective bytes by op")
    print(f"  {'op':20s} {'port':>14s} {'reference':>14s} {'port / ref':>10s}")
    for op, want in ref["bytes"].items():
        got = port[op]
        ratio = f"{got / want:10.3f}" if want else "         -"
        print(f"  {op:20s} {got:14.0f} {want:14.0f} {ratio}")
    for name, rows in (("port", port_top), ("reference", ref["top"])):
        by_dtype = {}
        for tot, _, _, _, shape in rows:  # a tuple's bytes under its first element's dtype
            dt = shape.lstrip("(").split("[")[0]
            by_dtype[dt] = by_dtype.get(dt, 0) + tot
        print(f"{name}: {len(rows)} (op, shape) groups, {sum(r[1] for r in rows)} collectives; bytes by dtype "
              f"{by_dtype}; top {args.top}")
        for tot, cnt, each, op, shape in rows[:args.top]:
            print(f"  {tot:12.0f} B  x{cnt:<4d} {each:10.0f} B  {op:18s} {shape}")


if __name__ == "__main__":
    main()
