"""One rank of the SPMD steps on a CPU ``gloo`` group.

Run as ``python tests/test_torch_spmd_worker.py RANK WORLD PORT OUT ARCH
KINDS`` by ``tests/test_torch_profile.py`` (four ranks, a (2, 2) mesh of
("data", "model")). KINDS is a comma-separated list of:

- ``train``: the federated train step, params under ``tp``;
- ``central``: the centralized train step, params under ``fsdp``;
- ``central_local``: the same step, but each rank draws its own blocks of
  the params (``launch.local.init_params``: the per-card init) and makes
  Yogi's state and the clustering state at local shape
  (``launch.local.train_state``), where ``central`` slices whole ones;
- ``prefill``: the serving prefill, params under ``tp``;
- ``decode``: two decode steps from a prefilled cache (random K/V and
  recurrent states, an index past the first slots) placed by
  ``cache_shardings``, params under ``tp``.
- ``decode_ring``: the long_500k placement at batch 1: the model's
  sliding-window variant (a ring of ``RING`` slots), three decode steps
  from an index past the ring's wrap whose writes cross from one card's
  slots into the next's, the cache placed by ``cache_shardings`` (the data
  axis on the ring, ``model`` on hd) and decoded with a window shorter
  than the ring (the ring's age mask masks slots of both shards);
- ``decode_seq``: the same at batch 2 with ``cache_shardings(seq_shard=
  True)`` (the batch over data, ``model`` on the ring); rank 0 also runs
  one device from params each moved one ulp up or down (a seeded coin), so
  the test can set the split's gap beside float32 rounding's own reach;
- ``decode_seq_full``: batch 2, ``seq_shard=True`` on a full cache of
  ``2 * RING`` slots (no window) at an index before the second card's
  slots, which the written-slots mask then masks whole.

The three sequence-split kinds run at depth 3: with 2 layers, as many as
the batch rows, ``cache_spec``'s match of the batch by value would put the
data axis on the layer axis.

Yogi's m and v are placed under ``fsdp``, the clustering state replicated
and the batch over ``data``, as the dry run's SPMD probe places them.
Every rank runs each step on the DTensors; rank 0 then runs the same step
on one device (plain tensors of the same values) and saves both results,
as full tensors, to OUT.
"""
import dataclasses
import sys

import numpy as np
import torch

C, M, S = 4, 2, 16  # clients x sequences x tokens of the train steps
PRE = 5  # cache slots filled before the decode steps
RING, WINDOW = 16, 12  # the sequence-split kinds' ring, and their decode window
# (batch, seq_shard, sliding window, cache index, decode window) of the sequence-split kinds
SEQ_SPLIT = {"decode_ring": (1, False, RING, RING + 7, WINDOW),
             "decode_seq": (2, True, RING, RING + 7, WINDOW),
             "decode_seq_full": (2, True, 0, PRE, -1)}


def config(arch: str):
    from repro_torch.configs import get_config, reduce_config

    cfg = reduce_config(get_config(arch)).replace(d_model=64, n_heads=4, n_kv_heads=2, vocab=128, d_ff=128,
                                                  attn_qchunk=8, ce_chunk=8)
    return cfg.replace(n_layers=2) if cfg.family != "hybrid" else cfg.replace(ssm_heads=4)


def _full(t):
    from repro_torch.utils import spmd

    return t.full_tensor() if spmd.is_dtensor(t) else t.clone()


def _tokens(shape, vocab, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32))


def run_train(step, params, opt, clust, batch):
    """(params, clust, metrics, assignments) of one train step, as full tensors."""
    from repro_torch.launch import steps
    from repro_torch.utils.tree import tree_map

    seen = {}
    orig = steps.clustering_update

    def update(state, sketches, ema=0.3):
        out = orig(state, sketches, ema)
        seen["assign"], seen["sketches"] = out[1]["assign"], sketches
        return out

    steps.clustering_update = update
    try:
        p, _, c, metrics = step(params, opt, clust, batch)
    finally:
        steps.clustering_update = orig
    return {"params": tree_map(_full, p), "clust": tree_map(_full, c), "metrics": tree_map(_full, metrics),
            "assign": _full(seen["assign"]), "sketches": _full(seen["sketches"])}


def _codebooks(cfg):
    """Audio tokens carry a codebook axis before the sequence."""
    return (cfg.n_codebooks,) if cfg.n_codebooks else ()


def _prefilled_cache(model, B, seed=1, max_seq=S, index=PRE):
    """A cache of ``B`` rows and ``max_seq`` positions whose float leaves
    hold random values and whose indices stand at ``index``: the state a
    prefill of that many tokens leaves."""
    from repro_torch.utils.tree import tree_map

    g = torch.Generator().manual_seed(seed)
    cache = model.init_cache(B, max_seq, device="cpu")

    def fill(a):
        if a.dtype.is_floating_point:
            return (0.5 * torch.randn(a.shape, generator=g, dtype=torch.float32)).to(a.dtype)
        return torch.full_like(a, index)

    return tree_map(fill, cache)


def one_ulp(params, seed=100):
    """Every float leaf of ``params`` moved one ulp up or down, by a seeded coin."""
    from repro_torch.utils.tree import tree_map

    g = torch.Generator().manual_seed(seed)

    def move(a):
        if not a.dtype.is_floating_point:
            return a.clone()
        up = torch.randint(0, 2, a.shape, generator=g, dtype=torch.bool)
        return torch.nextafter(a, torch.where(up, torch.inf, -torch.inf).to(a.dtype))

    return tree_map(move, params)


def _decode_tokens(cfg, B, t):
    return _tokens((B,) + _codebooks(cfg) + (1,), cfg.vocab, seed=10 + t)


def one_device_decode(step, params, cache, cfg, B, n_steps):
    """``n_steps`` decode steps of ``B`` rows on plain tensors: logits and cache."""
    out = {}
    for t in range(n_steps):
        out[f"logits{t}"], cache = step(params, cache, {"tokens": _decode_tokens(cfg, B, t)})
    out["cache"] = cache
    return out


def decode_steps(model, step_cfg, d_params, one_params, mesh, B, n_steps, seq_shard=False, max_seq=S,
                 index=PRE):
    """``n_steps`` decode steps of ``B`` rows from a prefilled cache placed
    by ``cache_shardings(seq_shard=)``, on the DTensors and (rank 0) on one
    device: (SPMD result, one-device result or None), logits and caches."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.utils import spmd
    from repro_torch.utils.tree import tree_map

    cache = _prefilled_cache(model, B, max_seq=max_seq, index=index)
    d_cache = tree_map(lambda a, p: spmd.place(a, mesh, p), cache, shd.cache_shardings(cache, B, mesh, seq_shard))
    one_cache = tree_map(torch.clone, cache)
    step = steps.make_serve_step(model, step_cfg)
    out = {}
    for t in range(n_steps):
        tokens = _decode_tokens(model.cfg, B, t)
        pl = shd.batch_shardings({"tokens": tokens}, mesh)["tokens"]
        logits, d_cache = step(d_params, d_cache, {"tokens": spmd.place(tokens, mesh, pl)})
        out[f"logits{t}"] = _full(logits)
    out["cache"] = tree_map(_full, d_cache)
    if torch.distributed.get_rank() != 0:
        return out, None
    return out, one_device_decode(step, one_params, one_cache, model.cfg, B, n_steps)


def case(kind, model, step_cfg, mesh):
    """(SPMD result, one-device result or None on ranks other than 0)."""
    from repro_torch import random as rnd
    from repro_torch.launch import local
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models.zoo import build_model
    from repro_torch.utils import spmd
    from repro_torch.utils.tree import tree_map

    if kind in SEQ_SPLIT:
        B, seq_shard, ring, index, window = SEQ_SPLIT[kind]
        model = build_model(model.cfg.replace(n_layers=3, sliding_window=ring))
        step_cfg = dataclasses.replace(step_cfg, window=window)
    cfg = model.cfg
    params = model.init(rnd.key(0), device="cpu")
    policy = "fsdp" if kind.startswith("central") else "tp"
    if kind == "central_local":
        d_params = local.init_params(model, rnd.key(0), mesh, policy, device="cpu")
    else:
        d_params = tree_map(lambda a, p: spmd.place(a, mesh, p), params, shd.param_shardings(params, mesh, policy))
    one_params = tree_map(torch.clone, params)
    rank0 = torch.distributed.get_rank() == 0

    def batch_of(batch):
        pl = shd.batch_shardings(batch, mesh)
        return {k: spmd.place(a, mesh, pl[k]) for k, a in batch.items()}

    if kind in ("train", "central", "central_local"):
        opt = steps.yogi_init(params)
        clust = steps.clustering_init(step_cfg.cluster_k, step_cfg.d_sketch, device="cpu")
        batch = {"tokens": _tokens((C, M, S) if kind == "train" else (C * M, S), cfg.vocab)}
        if kind == "central_local":
            d_opt, d_clust = local.train_state(d_params, mesh, step_cfg.cluster_k, step_cfg.d_sketch, device="cpu")
        else:
            opl = shd.param_shardings(params, mesh, "fsdp")
            d_opt = {k: tree_map(lambda a, p: spmd.place(a, mesh, p), v, opl) for k, v in opt.items()}
            d_clust = tree_map(lambda a: spmd.place(a, mesh, shd.replicated(mesh)), clust)
        one = [tree_map(torch.clone, t) for t in (opt, clust, batch)]
        make = (steps.make_train_step(model, step_cfg) if kind == "train"
                else steps.make_central_train_step(model, step_cfg, n_clients=C))
        got = run_train(make, d_params, d_opt, d_clust, batch_of(batch))
        return got, (run_train(make, one_params, *one) if rank0 else None)
    if kind == "prefill":
        batch = {"tokens": _tokens((C,) + _codebooks(cfg) + (S,), cfg.vocab)}
        step = steps.make_prefill_step(model, step_cfg)
        got = {"logits": _full(step(d_params, batch_of(batch)))}
        return got, ({"logits": step(one_params, batch)} if rank0 else None)
    if kind in SEQ_SPLIT:
        got, want = decode_steps(model, step_cfg, d_params, one_params, mesh, B, 3, seq_shard, 2 * RING, index)
        if kind != "decode_seq" or not rank0:
            return got, want
        ulp = one_device_decode(steps.make_serve_step(model, step_cfg), one_ulp(params),
                                _prefilled_cache(model, B, max_seq=2 * RING, index=index), cfg, B, 3)
        return got, want, ulp
    # decode: two steps from a prefilled cache
    return decode_steps(model, step_cfg, d_params, one_params, mesh, C, 2)


def main(rank: int, world: int, port: int, out: str, arch: str, kinds: str = "train"):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import steps
    from repro_torch.models.zoo import build_model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
        model = build_model(config(arch))
        step_cfg = steps.StepConfig(d_sketch=32)
        res = {}
        for kind in kinds.split(","):
            with implicit_replication():
                res[kind] = dict(zip(("spmd", "one", "ulp"), case(kind, model, step_cfg, mesh)))
        if rank == 0:
            torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], *sys.argv[6:7])
