"""Dry run: the per-card memory, FLOP and collective plan of every
(arch × shape) on the production mesh, on an H100 (port of
``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

No card is needed, as the reference's dry run needs no TPU: the mesh is
built on the fake process group (``launch.mesh.init_fake_world``) and
every step runs under ``FakeTensorMode``, which allocates nothing. The
fake tensors are CUDA tensors where the torch build has CUDA, else CPU
tensors of the same shapes and dtypes (a CPU-only build cannot index fake
CUDA tensors); the kernel wrappers give either the kernel's output
allocation and no launch.

The probe is an SPMD execution, as the reference's ``_compile_one`` is a
compiled SPMD program: the step's state and inputs are DTensors on the
mesh (params under the policy, Yogi's m and v under ``fsdp``, the
clustering state replicated, the batch by ``batch_shardings``, the decode
cache by ``cache_shardings``), the step runs as one program over the
mesh (``utils.spmd`` holds its explicit rules), and one card's local
tensors are counted (``utils.hlo.count_step``), its collectives recorded.

Per card, the report holds:
  - state bytes: what lives between steps, exact from the specs
    (``sharding.per_card_bytes``, ``sharding.cache_bytes``);
  - input bytes: the card's share of the batch;
  - step peak: what the step allocates on top (client deltas, gradients,
    activations, temporaries, collective buffers), the peak live bytes of
    the card's local tensors in 1- and 2-unit probes, extrapolated as
    ``base + per_unit × units``; past 2 units a 3-unit probe too, and the
    plan is the last probe's peak plus the largest per-unit step for each
    unit beyond it (``_extrap_peak``: the peak's growth can rise with
    depth);
  - ``fits``: state + inputs + step peak within the card's 80 GB.
FLOPs, bytes accessed and collective bytes (by op, and weighted: an
all-reduce twice) come from the same probes, extrapolated the same way,
as the reference extrapolates them from its 1- and 2-unit programs.
``collective_s`` is the weighted bytes over one card's NVLink bandwidth.

Results land in ``experiments/dryrun_h100/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import sketch
from repro_torch.kernels import sketch_project as sketch_kernel
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.specs import SDS, TRAIN_CLIENTS, effective_config, flat_batch_specs, input_specs
from repro_torch.launch.steps import (
    StepConfig,
    make_central_train_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    yogi_init,
)
from repro_torch.models.zoo import build_model
from repro_torch.utils import hlo, spmd
from repro_torch.utils.tree import leaves, tree_map

# archs whose params cannot be replicated per data shard: FSDP + centralized
FSDP_ARCHS = {"qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"}

OUT_DIR = Path("experiments/dryrun_h100")

def _pattern_len(cfg) -> int:
    """Layers per repeating unit (superblock) of this family."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family == "ssm":
        return cfg.slstm_every
    if cfg.is_moe_arch and cfg.moe_interleave > 1:
        return cfg.moe_interleave
    return 1


def _with_units(cfg, units: int):
    """Shrink the config to `units` repeating units (probe size)."""
    return cfg.replace(n_layers=_pattern_len(cfg) * units)


def fake_device() -> str:
    """The fake tensors' device: the card's where torch has CUDA built in."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _local_batch(batch: Dict[str, Any], mesh, seq_shard: bool) -> Dict[str, Any]:
    """The card's share of a batch of ShapeDtype records."""
    return {k: s._replace(shape=shd.local_shape(s.shape, shd.batch_leaf_spec(s.shape, s.dtype, mesh, seq_shard),
                                                mesh))
            for k, s in batch.items()}


@contextlib.contextmanager
def _one_draw_per_leaf(counter: hlo.StepCounter):
    """The sketch projects a large leaf through one Rademacher block of
    2**16 rows after another (``core.sketch.projection_blocks``; a split
    leaf's shard, ``core.sketch.row_blocks``), each a threefry hash of ~200
    aten ops: thousands of blocks a step, which fake tensors would replay
    one op at a time. Here the first block of a leaf is drawn (its
    temporaries and traffic counted as they come) and stands for the
    others, whose draws add the first one's bytes; every block's product
    with the leaf is still dispatched and counted."""
    orig, orig_rows = sketch.projection_blocks, sketch.row_blocks

    def blocks(n, d_sketch, seed, device):
        before = counter.bytes_accessed
        first = next(iter(orig(n, d_sketch, seed, device)))
        per = counter.bytes_accessed - before
        yield first
        for _ in range(sketch.n_blocks(n) - 1):
            counter.bytes_accessed += per
            yield first

    def rows(index, n, d_sketch, seed):
        before = counter.bytes_accessed
        _, first = next(iter(orig_rows(index, n, d_sketch, seed)))
        per = counter.bytes_accessed - before
        yield 0, first
        for lo in range(sketch.ROW_CHUNK, index.shape[0], sketch.ROW_CHUNK):
            counter.bytes_accessed += per
            yield lo, first[:index.shape[0] - lo]

    sketch.projection_blocks, sketch.row_blocks = blocks, rows
    try:
        yield
    finally:
        sketch.projection_blocks, sketch.row_blocks = orig, orig_rows


@contextlib.contextmanager
def _sketch_kernel_bytes(counter: hlo.StepCounter):
    """A leaf that the sketch projects in one kernel call
    (``kernels.sketch_project``) dispatches no aten op for it on a fake
    tensor: the call's bytes (the rows read once, the partial sums written
    and read back, the output) and its products' FLOPs (2 R n d, the signs'
    hashing not counted) are added here."""
    orig = sketch_kernel.sketch_project

    def counted(flat, block, d, seed):
        R, n = flat.shape
        counter.bytes_accessed += sketch_kernel.call_bytes(R, n, block, d, flat.element_size())
        counter.flops += 2 * R * n * d
        return orig(flat, block, d, seed)

    sketch_kernel.sketch_project = counted
    try:
        yield
    finally:
        sketch_kernel.sketch_project = orig


def _placed(shape, dtype, placements, mesh, dev):
    """An uninitialized DTensor of ``shape`` on ``mesh`` (each card's shard
    allocated; a fake tensor under ``FakeTensorMode``)."""
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return spmd.from_local(torch.empty(local, dtype=dtype, device=dev), mesh, placements)


def _state(shapes, kind: str, batch: Dict[str, Any], step_cfg: StepConfig, mesh, policy: str, dev,
           cache_shapes, seq_shard_cache: bool):
    """The step's state and inputs on ``dev`` (fake tensors): plain tensors
    without a mesh; DTensors placed as the reference's ``_compile_one``
    places them with one (params under ``policy``, Yogi's m and v under
    ``fsdp``, the clustering state replicated, the batch by
    ``batch_shardings``, the decode cache by ``cache_shardings``)."""
    if mesh is None:
        place = lambda a, pl=None: torch.empty(a.shape, dtype=a.dtype, device=dev)  # noqa: E731
        pshard = oshard = tree_map(lambda a: None, shapes)
        bshard = {k: None for k in batch}
        repl = None
    else:
        place = lambda a, pl: _placed(a.shape, a.dtype, pl, mesh, dev)  # noqa: E731
        pshard = shd.param_shardings(shapes, mesh, policy)
        oshard = shd.param_shardings(shapes, mesh, "fsdp")
        bshard = shd.batch_shardings(batch, mesh, seq_shard=policy == "dp")
        repl = shd.replicated(mesh)
    state = {"params": tree_map(place, shapes, pshard),
             "inputs": {k: place(s, bshard[k]) for k, s in batch.items()}}
    if kind == "train":
        f32 = tree_map(lambda a: SDS(a.shape, torch.float32), shapes)
        state["opt"] = {"m": tree_map(place, shapes, oshard), "v": tree_map(place, f32, oshard)}
        k, d = step_cfg.cluster_k, step_cfg.d_sketch
        state["clust"] = {name: place(SDS(sh, torch.float32), repl)
                          for name, sh in (("centroids", (k, d)), ("counts", (k,)), ("initialized", ()))}
    if kind == "decode":
        B = batch["tokens"].shape[0]
        cache = tree_map(lambda a: SDS(tuple(a.shape), a.dtype), cache_shapes)
        cshard = (tree_map(lambda a: None, cache) if mesh is None
                  else shd.cache_shardings(cache, B, mesh, seq_shard_cache))
        state["cache"] = tree_map(place, cache, cshard)
    return state


def probe_step(cfg, kind: str, batch: Dict[str, Any], step_cfg: StepConfig, central: bool = False,
               n_clients: int = TRAIN_CLIENTS, cache_len: int = 0, mesh=None, policy: str = "tp",
               seq_shard_cache: bool = False) -> hlo.StepCounts:
    """One step of ``cfg`` on fake tensors: its FLOPs, bytes, peak live bytes
    and collectives on one card, the step's state and inputs registered as
    external. Without ``mesh``, ``batch`` is the card's ShapeDtype inputs
    and the step runs on plain tensors. With one (the SPMD probe), ``batch``
    is the whole batch, the state and inputs are DTensors placed on
    ``mesh`` under ``policy``, and the step runs as one program over the
    mesh (the fake process group's), counted on the card's local tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = fake_device()
    model = build_model(cfg)
    # shapes from meta tensors, made outside the fake mode
    shapes = tree_map(lambda a: SDS(tuple(a.shape), a.dtype), model.init_shapes())
    cache_shapes = None
    if kind == "decode":
        cache_shapes = model.init_cache(batch["tokens"].shape[0], cache_len, torch.bfloat16, device="meta")
    with FakeTensorMode():
        st = _state(shapes, kind, batch, step_cfg, mesh, policy, dev, cache_shapes, seq_shard_cache)
        params, inputs = st["params"], st["inputs"]
        external = leaves(st)
        if kind == "train":
            step = (make_central_train_step(model, step_cfg, n_clients=n_clients) if central
                    else make_train_step(model, step_cfg))
            fn = lambda: step(params, st["opt"], st["clust"], inputs)  # noqa: E731
        elif kind == "prefill":
            fn = lambda: make_prefill_step(model, step_cfg)(params, inputs)  # noqa: E731
        else:
            fn = lambda: make_serve_step(model, step_cfg)(params, st["cache"], inputs)  # noqa: E731
        counter = hlo.StepCounter()
        spmd_ctx = contextlib.nullcontext() if mesh is None else _implicit_replication()
        with _one_draw_per_leaf(counter), _sketch_kernel_bytes(counter), spmd_ctx:
            return hlo.count_step(fn, external, counter)


def _implicit_replication():
    """Plain tensors the models make themselves (positions, masks, RoPE
    tables) join DTensor ops as replicated ones."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _extrap(a1: float, a2: float, n_units: float) -> float:
    per_unit = max(a2 - a1, 0.0)
    base = max(a1 - per_unit, 0.0)
    return base + per_unit * n_units


def _extrap_peak(peaks, n_units: float) -> float:
    """The step peak at ``n_units`` from probes at 1, 2 (and, past 2 units,
    3) units: the last probe plus the largest per-unit step for each unit
    beyond it. A peak is the highest of several moments of the step, each
    growing with depth at its own rate, so its per-unit step can grow from
    one probe to the next (granite-3-2b's round under tp on (1, 4): +0.122
    GB from 1 to 2 layers, +0.167 from 2 to 3, +0.182 a layer from 3 on)."""
    if len(peaks) < 3:
        return _extrap(peaks[0], peaks[1], n_units)
    per_unit = max(max(b - a for a, b in zip(peaks, peaks[1:])), 0.0)
    return peaks[-1] + per_unit * (n_units - len(peaks))


def plan_step(cfg, kind: str, batch: Dict[str, Any], mesh, policy: str, step_cfg: StepConfig,
              n_clients: int = TRAIN_CLIENTS, cache_len: int = 0, seq_shard_cache: bool = False,
              probes: bool = True) -> Dict[str, Any]:
    """The per-card plan of one step of ``cfg`` (full depth) on ``mesh``:
    ``batch`` is the whole batch (ShapeDtype records); the SPMD probe runs
    the step over the mesh and counts one card. A train step under
    ``fsdp`` is the centralized step, as in the reference's dry run.
    ``probes=False`` skips the small probes and their extrapolation: one
    probe at the config's own depth gives every figure."""
    central = kind == "train" and policy == "fsdp"
    local = _local_batch(batch, mesh, seq_shard=policy == "dp")
    shapes = build_model(cfg).init_shapes()
    state = {"params": shd.per_card_bytes(shapes, mesh, policy)}
    if kind == "train":
        opt = yogi_init(shapes)
        state["optimizer"] = sum(shd.per_card_bytes(v, mesh, "fsdp") for v in opt.values())
        state["clustering"] = 4 * step_cfg.cluster_k * (step_cfg.d_sketch + 1) + 4
    if kind == "decode":
        B = next(iter(batch.values())).shape[0]
        cache = build_model(cfg).init_cache(B, cache_len, torch.bfloat16, device="meta")
        state["cache"] = shd.cache_bytes(cache, B, mesh, seq_shard_cache)
    input_bytes = sum(math.prod(s.shape) * s.empty().element_size() for s in local.values())

    plen = _pattern_len(cfg)
    n_units = cfg.n_layers / plen
    t0 = time.time()
    # FLOPs, bytes and collectives from 1 and 2 units, as the reference
    # extrapolates them; past 2 units a third probe for the step peak
    units = ((1, 2, 3) if n_units > 2 else (1, 2)) if probes else (n_units,)
    counts = [probe_step(_with_units(cfg, u) if probes else cfg, kind, batch, step_cfg, central, n_clients,
                         cache_len, mesh=mesh, policy=policy, seq_shard_cache=seq_shard_cache) for u in units]
    probe_s = time.time() - t0
    if probes:
        step_peak = _extrap_peak([c.step_peak_bytes for c in counts], n_units)

        def term(f):
            return _extrap(f(counts[0]), f(counts[1]), n_units)
    else:  # the whole step counted once: every figure is its own
        step_peak = counts[0].step_peak_bytes

        def term(f):
            return f(counts[0])

    def coll(c):
        return hlo.collective_bytes(c.collectives)

    roof = hlo.Roofline(
        flops=term(lambda c: c.flops),
        bytes_accessed=term(lambda c: c.bytes_accessed),
        coll_bytes=term(lambda c: coll(c)["total_weighted"]),
        coll_by_op={k: term(lambda c, k=k: coll(c)[k]) for k in coll(counts[0]) if k != "total_weighted"},
        peak_flops=hlo.peak_flops(cfg.dtype),
    )
    state_bytes = sum(state.values())
    plan = state_bytes + input_bytes + step_peak
    return {
        "step": "central_train" if central else ("federated_train" if kind == "train" else kind),
        "local_batch": {k: list(s.shape) for k, s in local.items()},
        "state_bytes": state_bytes,
        "state_by_part": state,
        "input_bytes": input_bytes,
        "step_peak_bytes": step_peak,
        "plan_bytes": plan,
        "fits": plan <= hlo.HBM_BYTES,
        "hbm_bytes": hlo.HBM_BYTES,
        "probes": {"units": list(units), "n_units": n_units, "step_peak_bytes": [c.step_peak_bytes for c in counts],
                   "flops": [c.flops for c in counts], "bytes": [c.bytes_accessed for c in counts],
                   "coll_bytes": [coll(c)["total_weighted"] for c in counts],
                   "n_collectives": [len(c.collectives) for c in counts], "seconds": probe_s},
        "flops_probe": term(lambda c: c.flops),
        "per_device_note": "FLOPs, bytes, step peak and collectives of one card's local tensors in the SPMD probe",
        "roofline": roof.as_dict(),
    }


def parse_overrides(kvs) -> Dict[str, Any]:
    """``--set k=v`` config overrides (integers where they parse)."""
    out = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        out[k] = int(v) if v.lstrip("-").isdigit() else v
    return out


def lower_one(arch: str, shape_name: str, multi_pod: bool, policy_override=None,
              step_cfg: StepConfig = None, extra_tag: str = "", probes: bool = True,
              cfg_overrides: dict = None, seq_shard_cache: bool = False) -> Dict[str, Any]:
    """Plan one (arch, shape, mesh) and return the report dict. With
    ``probes=False`` the plan counts the whole step once instead of
    extrapolating from small probes (``roofline_extrapolated`` false)."""
    t0 = time.time()
    cfg0 = get_config(arch)
    shape = SHAPES[shape_name]
    cfg = effective_config(cfg0, shape).replace(dtype=torch.bfloat16)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=fake_device())
    policy = policy_override or ("fsdp" if arch in FSDP_ARCHS else "tp")
    step_cfg = step_cfg or StepConfig()
    if shape.kind == "train" and policy == "fsdp":
        batch = flat_batch_specs(cfg, shape)  # the centralized step takes the flat (B, S) batch
    else:
        batch = input_specs(cfg0, shape.name)
    plan = plan_step(cfg, shape.kind, batch, mesh, policy, step_cfg, cache_len=shape.seq_len,
                     seq_shard_cache=seq_shard_cache, probes=probes)

    model = build_model(cfg)
    n_params = model.param_count()
    n_active = model.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens
    flops_global = plan["flops_probe"] * mesh.size()
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "policy": policy,
        "kind": shape.kind,
        "variant": "sliding_window" if cfg.sliding_window and not cfg0.sliding_window else "native",
        "overrides": cfg_overrides or {},
        "tag": extra_tag,
        "accum_steps": step_cfg.accum_steps,
        "device": "NVIDIA H100 80GB HBM3 (planned; nothing runs on a card)",
        "params": n_params,
        "active_params": n_active,
        "tokens": tokens,
        "model_flops": model_flops,
        "flops_global": flops_global,
        "useful_flops_ratio": model_flops / flops_global if flops_global else 0.0,
        "memory": {k: plan[k] for k in ("state_bytes", "state_by_part", "input_bytes", "step_peak_bytes",
                                        "plan_bytes", "fits", "hbm_bytes")},
        "fits": plan["fits"],
        "step": plan["step"],
        "local_batch": plan["local_batch"],
        "probes": plan["probes"],
        "per_device_note": plan["per_device_note"],
        "roofline": plan["roofline"],
        "roofline_extrapolated": probes,
        "plan_s": time.time() - t0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default=None, choices=[None, "tp", "fsdp", "ep", "dp"])
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (centralized mode; no step reads it yet)")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    help="shard decode caches over the sequence (flash-decode)")
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides, e.g. --set vocab_pad=49168")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    failures = []
    for arch in archs:
        arch = arch.replace("_", "-") if "-" not in arch else arch
        for shape in shapes:
            for multi in meshes:
                mesh_tag = "2x16x16" if multi else "16x16"
                name = f"{arch}__{shape}__{mesh_tag}" + (f"__{args.tag}" if args.tag else "")
                step_cfg = StepConfig(accum_steps=args.accum) if args.accum != 1 else None
                overrides = parse_overrides(args.set)
                try:
                    rep = lower_one(arch, shape, multi, args.policy, step_cfg=step_cfg,
                                    extra_tag=args.tag, cfg_overrides=overrides or None,
                                    seq_shard_cache=args.cache_seq_shard)
                    (outdir / f"{name}.json").write_text(json.dumps(rep, indent=2))
                    r, m = rep["roofline"], rep["memory"]
                    print(
                        f"OK  {name:60s} compute={r['compute_s'] * 1e3:8.2f}ms "
                        f"memory={r['memory_s'] * 1e3:8.2f}ms coll={r['collective_s'] * 1e3:8.2f}ms "
                        f"bottleneck={r['bottleneck']:10s} plan={m['plan_bytes'] / 1e9:7.2f}GB "
                        f"fits={m['fits']} ({rep['plan_s']:.0f}s)",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001
                    failures.append((name, repr(e)))
                    print(f"FAIL {name}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for n, e in failures:
            print(" ", n, e)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
