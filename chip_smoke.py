#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, as CI on the card runs it
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only
    python3 chip_smoke.py --decode-timing [--src DIR]  # build + phase 9 alone,
        # of the package under DIR (default ./src): time two versions in turns
    python3 chip_smoke.py --kernel-timing [--src DIR]  # build + phase 6's fixed
        # rows of the segment and cosine kernels and the LM rows (1, 2, n) -> 1
        # weighted at n = 41.9M and 671M alone, likewise
    python3 chip_smoke.py --lm-train      # build + phase 10 alone
    python3 chip_smoke.py --engine-modes  # build + phase 4's run + phase 11 alone
    python3 chip_smoke.py --eval-baselines  # build + phase 4a and 4's runs + phase 12 alone
    python3 chip_smoke.py --families      # build + phase 13 alone
    python3 chip_smoke.py --ssm           # build + phase 14 alone
    python3 chip_smoke.py --placement     # build + a warm-up run + phase 15 alone
    python3 chip_smoke.py --launch        # build + phase 16 (its two steps run for their peaks)
    python3 chip_smoke.py --spmd          # build + phase 16 + phase 17
    python3 chip_smoke.py --maverick      # build + phase 18 alone, its step at
        # the full 48 layers
    python3 chip_smoke.py --drivers       # build + phase 19 alone
    python3 chip_smoke.py --options       # build + phase 20 alone (with a warm-up round)
    python3 chip_smoke.py --paper         # build + phase 21 alone
    python3 chip_smoke.py --paper-full    # build, two dry-run plans, then every suite of
        # ``python -m repro_torch.paper.run --full`` (paper scale; not in the default run)

Phases (any failure exits non-zero; no phase catches an error and goes on):
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  3. kernel vs plain version on the card, over the JAX kernel tests' shape
     sweep, the main-path shapes, stage 2 at 32 and 64 cohorts (K = 63,
     127), the kernels_micro shapes and 9000 rows (past two chunks of the
     segment kernel's row lists), f32 and bf16, with a cohort axis,
     int64 and int32 ids (the segment kernel bit-equal to the plain
     version on a CPU copy, the others at their tolerances); two launches
     bit-identical at K = 63 and at (8192, 512, 32);
  4. the main path: ``run_auxo`` on the openimage-like population with the
     paper benchmarks' settings; every kernel must have launched;
  5. determinism: a second run from the same seed is bit-identical;
  6. timing at the main-path shapes (CUDA events, median of >= 20 runs):
     the largest call shapes of the main run and its largest D = 1 call,
     stage 2 at 63 segments and the kernels_micro shapes (rotated over
     input copies past the 50 MB L2), each beside its bound, the plain
     version, its eager time and one library call;
  7. paged cohort decode at granite-3-2b's full width: a 3-slot bank from
     ``model_init``, 2 live cohorts x 4 lanes, 16 steps, a partition, 16
     more; every decode-kernel call of the path held against the plain
     version on the same inputs (2e-5), and a plain-backend decoder beside
     it (same greedy tokens up to a near tie); tokens/s, peak memory and
     the share of the weight-bytes bound per step;
  8. the serving plane: a 2000-query burst through ``ServingPlane`` on the
     engine of the main run, one inference per admitted batch, a repeated
     cold batch served from the probe cache; queries/s;
  9. timing of decode attention at the main-path call (f32, bf16), at a
     32k cache of 8 sequences (full f32 and bf16, ragged bf16) and at the
     decode_32k batch (128 x 32k, bf16), beside its byte bound, the plain
     version and ``F.scaled_dot_product_attention``;
 10. LM training (``repro_torch.launch.steps``), after phase 9 has freed its
     memory: (a) 3 rounds of ``make_train_step`` on a reduced granite-3-2b on
     the card and on the CPU, equal assignments and close state; (b)
     granite-3-2b at full width and depth, float32, 2 clients x 2 sequences
     of 512 tokens (``synth_corpus``), 3 rounds: s/round, loss, tokens/s,
     the share of the FLOP bound, peak memory, the sketch's and every
     aggregation call's time; every aggregation call on the segment kernel,
     none on a plain version; (c) 2 ``make_central_train_step`` steps, a
     prefill of 2 x 512 tokens and 8 served tokens, all finite; then the LM
     path's segment calls held against the plain version and timed;
 11. engine modes (the plain versions raise on CUDA tensors throughout,
     each path's round-kernel launches counted from 0): (a) the sequential
     oracle beside the batched round on ``tests/test_pipeline.py``'s scenario
     (300 clients, 30 rounds, two partitions), both from the same bank each
     round; (b) ``round_overlap=1`` bit-equal to the stale-sync oracle (a
     synchronize after every dispatch), then phase 4's run overlapped
     (s/round beside phase 4's) and its steps alone, synchronous and
     overlapped, with the calls that synchronized with the card counted per
     overlapped round (sync debug mode "warn"); (c) the population plane at
     100,000 and 1,000,000 clients (``ProceduralDataPlane``, the chunked
     store, chunked availability, churn), synchronous and overlapped,
     6 rounds each, and the store-versus-dense scenario bit-equal; then
     every call shape of the phase held against the plain version.
 12. evaluation and baselines (plain versions raise on CUDA tensors, every
     path's launches counted from 0; FTFA and the four baselines launch
     none): (a) ``ftfa_eval(steps=5)`` on
     phase 4's engine (1000 clients -> 100 rows), then on phase 4a's
     120-client engines, card against CPU at the round tolerance; (b)
     ``examples/robust_fl.py``'s failover on phase 4's engine: checkpoint ->
     recover, ``rebuild_from_requests`` from 200 clients' requests, and
     ``feedback`` on the card and on the CPU from the same checkpoint
     (equal assignments, rewards within 1e-5 relative); (d) every call
     shape of the phase held against the plain version (Table 5, once
     12c, runs in phase 21).
 13. the model families (plain versions raise on CUDA tensors; the phase's
     segment launches counted from 0): (a) reduced qwen3-moe and llama4
     (4 experts), 3 federated rounds and 2 central steps each, on the CPU
     and twice on the card: equal assignments and counts, states within
     tests/test_torch_moe.py's margins, the two card runs bit-identical;
     (b) qwen3-moe-235b-a22b at full width, depth 1 (of 94), float32: 3
     central steps on 4 x 512 tokens (s/step, tokens/s, the share of the
     FLOP bound, peak memory, lb/z losses and frac_dropped), the router,
     dispatch, experts and combine device ms of one forward, a prefill of
     2 x 512 and 8 served tokens; (c) qwen2-vl-2b (1024 image patches + 512
     tokens) and musicgen-large (4 codebooks) at full width and depth: one
     central step, a prefill and 8 served tokens each; (d) every segment
     call shape of the phase held against the plain version.
 14. the SSM and hybrid families (plain versions raise on CUDA tensors;
     the phase's segment launches counted from 0): (a) reduced xlstm-1.3b
     and zamba2-7b (``ssm_chunk`` 16; zamba2's central steps at 5 layers,
     ``attn_every`` 2, so the shared block is applied twice and a tail
     layer runs), 3 federated rounds and 2 central steps each, on the CPU
     and twice on the card: equal assignments and counts, every step's
     state within tests/test_torch_ssm_families.py's margins, the two card
     runs bit-identical; 8 tokens decoded one at a time against the
     chunked forward (5e-3, tests/test_models.py's); (b) xlstm-1.3b at full
     width and depth, float32: 2 federated rounds on 2 clients x 2 x 512
     tokens (s/round, tokens/s, the share of the FLOP bound, peak memory,
     the sketch's device seconds, every aggregation call's ms), one sLSTM
     layer's time loop alone, a prefill of 2 x 512 and 8 served tokens;
     (c) zamba2-7b at full width, depth 39 of 81: 2 central steps on 4 x
     512 tokens, a prefill and 8 served tokens; (d) every segment call
     shape of the phase held against the plain version, the largest timed.
 15. cohort placement and elastic checkpoints, S logical shards on card 0
     (plain versions raise on CUDA tensors; every path's launches counted
     from 0): (a) tests/test_cohort_sharding.py's C = 32 scenario, 3 rounds
     at 8 shards against one device (equal leaves, params at 1e-5, one
     dispatch a round, no dropped rows) and a spawn across blocks after the
     first step; (b) phase 4's run at 4 shards, at the full row width
     against one device (equal partitions) and at the automatic width
     (dropped rows, s/round); (c) benchmarks/elastic_restore.py's scenario,
     a save/load every 5 of 30 rounds in both overlap modes (bit-equal;
     save, load, overhead), the remesh 2 -> 4 and 2 -> 1 (discrete state
     equal, params printed bit-equal or at rtol 1e-4 / atol 1e-5), a CPU
     checkpoint continued on the card, and the layout gate: one segment's
     25 rows at offsets 0 and 37, in blocks 1 and 3, straddling rows 256,
     512 and 1024, narrow (D = 1), wide (D = 6922) and D = 512, f32
     and bf16, every call bit-equal to the plain version on a CPU copy;
     then every call shape of the phase held against the plain version.
 16. the launch plan (``repro_torch.launch.dryrun.plan_step`` on the fake
     process group, a (1, 1) mesh and fake CUDA tensors: nothing is
     allocated) of phase 10b's granite-3-2b round and phase 13b's
     qwen3-moe central step, each beside the peak that phase measured;
     a plan more than 10% below its peak fails; each records 0 collectives.
 17. the SPMD probe: (a) ``repro_torch.launch.profile`` of granite-3-2b
     ``train_4k`` (tp) and qwen3-moe-235b-a22b ``train_4k`` (fsdp) on the
     16 x 16 mesh of the fake process group with fake CUDA tensors (at most
     1 MiB allocated on the card): one card's collective GB by op and the
     top 20 collectives; (b) phase 16's two plans recorded 0 collectives on
     (1, 1); (c) phase 10b's granite-3-2b round at full width (depth cut to
     8 layers, so that the plan extrapolates from its 1-, 2- and 3-layer
     probes) under tp as rank 0 of a (1, 4) fake world, with real local
     shards on the card: the measured peak against the SPMD plan (plan /
     measured >= 0.9), the recorded collectives equal to the fake-tensor
     probe's (op, shape, dtype, count), both round kernels' launches
     counted from 0, and every segment-kernel call on the local shards
     bit-equal to the plain version on a CPU copy. The fake group moves no
     data, so the round's loss is not held.
 18. llama4-maverick-400b-a17b at full width (bf16, as the dry run plans
     ``train_4k``): (a) one MoE layer's ``moe/wg`` (128, 5120, 8192) float32
     drawn whole on the card by ``dense_init`` (a chunk at a time): at most
     1 GB besides its 21.47 GB output; rows of experts 0, 102 (where the
     threefry counters pass 2**32), 103 and 127 drawn alone on the card
     bit-equal, and on a CPU copy of the key with equal threefry bits and
     values within ``ERFINV_ULP`` (the devices' erfinv differ); (b) the
     blocks of mesh coordinates (0, 15) and (0, 0) of the 16 x 16 mesh under
     ``fsdp`` drawn alone (``Model.init_local``), each leaf's first and last
     block rows held likewise; (c) ``train_4k``'s central step (depth cut to
     8 of 48 layers; ``--maverick`` runs all 48) as rank 0 of a 256-rank
     fake world on rank 0's real blocks: plan / measured >= 0.9, the
     collectives equal to the fake probe's, both kernels' launches counted
     from 0 over two steps (the segment kernel's bit-equal to the plain
     version on a CPU copy, the cosine's 0), the second step's seconds
     beside the plan's roofline, and the card's busy share under the
     profiler. The fake group moves no data: the loss is not held.
 19. the drivers: (a) granite-3-2b's ``long_500k`` decode (its
     sliding-window variant: a 4096-slot ring, batch 1; the data axis on
     the ring, ``model`` on hd) and (b) its ``decode_32k`` decode under
     ``--cache-seq-shard`` (batch 128 over data, ``model`` on the 32,768
     slots), each at full width (bf16, depth cut to 8 layers: the plan
     probes 1, 2 and 3) as rank 0 of the 16 x 16 fake world on rank 0's
     real local shards, params under tp drawn shard-locally, 4 decode
     steps from an index 4 short of the shape's length: plan / measured
     >= 0.9 and every step's collectives equal to the fake-tensor probe's;
     (c) ``launch.train --rounds 3`` as a 1-rank NCCL group under
     ``torch.distributed.run`` against the one-device driver in this
     process: checkpoints equal at tests/test_torch_train_ranks.py's
     tolerances, the same printed losses, the segment kernel launched;
     (d) the four ``examples/port_*.py`` on the card at their defaults
     (``port_train_lm_federated`` at ``--rounds 30``), each one's kernel
     launches counted from 0 (quickstart and robust_fl launch both round
     kernels, train_lm_federated the segment kernel, serve_cohorts none)
     and its last lines printed.
 20. the reference's last options: (a) a ``tp`` CohortBank of granite-3-2b
     at full width (depth 1 of 40: a 0.646 GB f32 slot), capacity 8, on
     ``make_cohort_mesh(4, model=2, devices=[cuda:0] * 8)`` beside a ``dp``
     bank: 7 spawns, every slot's params and Yogi m, v bit-equal, the
     bytes a model position holds, and the params re-packed (4 x 2) ->
     (2 x 2) -> (1 x 1) into each target's pieces, bit-equal to the dp
     bank's re-pack; (b) phase 10b's granite-3-2b round at full width,
     depth 8 of 40, once under ``remat_policy`` "full" and once under
     "outputs" from the same state: losses equal as printed, the params'
     largest gap, s/round, the peak against the dry run's plan on (1, 1)
     (plan / measured >= 0.9), every segment call held bit-equal to the
     plain version on a CPU copy, the launches counted from 0; (c) phase
     4's run served 64 queries one at a time by ``ServingPlane(max_batch=1,
     bucket_min=1)`` and at once by the batched plane: the same answers.
 21. the paper's drivers (``repro_torch.paper``; plain versions raise on
     CUDA tensors, every run's round-kernel launches counted from 0): (a)
     each driver at 16 rounds on its own full-size scenario (Tables 3 and
     4 on openimage-like; Figures 13 and 14 at each sweep's default and one
     other value), and Table 5 at its own settings on femnist-like (800
     clients, 80 rounds, k 4: Auxo, the paper-faithful Auxo, IFCA, FL+HC,
     FlexCFL, and CFL on its 100-client scenario, with 12c's cost
     invariants): finite rows, Auxo partitioned, Auxo runs launching both
     round kernels, the no-cohort runs and Figure 12's engine the segment
     kernel, the baselines none; (b) Table 3 on a 120-client cut on the
     card and on the CPU: equal discrete fields, floats within the round
     tolerance; (c) every call shape of the phase held against the plain
     version.
Memory plan of phase 7 (float32, the reference's dtype): the bank holds 3
slots of 2,533,531,648 params (30.4 GB), ``decode`` gathers the 2 live rows
(20.3 GB), the paged KV cache is 0.17 GB: about 51 GB of the card's 80 GB.
Memory plan of phase 10b: params, Yogi's m and v (30.4 GB), the two
clients' deltas, one of them the working copy (20.3 GB), one SGD step's
gradients (10.1 GB) and checkpointed activations (~1 GB): about 62-64 GB.
Memory plan of phase 13b: one layer at full width is 3,696,767,104 params
(2.45B the layer, 1.24B the untied embedding and head); params, Yogi's m
and v and one set of gradients are 59.1 GB, and ``_yogi_leaf``'s
temporaries on the largest leaf (an expert weight, 3.22 GB) add up to
~10 GB: ~70 GB of the card's 80. Two layers would need ~98 GB.
Memory plan of phase 14b: xlstm-1.3b's params, Yogi's m and v (24.2 GB),
the two clients' deltas (16.2 GB), one SGD step's gradients (8.1 GB);
the aggregation then frees each delta leaf as FedYoGi takes it (three
2.8 GB temporaries on ``w_up``): ~50-56 GB. Phase 14c: zamba2-7b at
depth 39 is 3,475,767,600 params; params, m, v and gradients are 55.6 GB
(at depth 81, 108 GB: the cut's reason).
Memory plan of phase 18c: rank 0's state at 8 layers is 2.13 GB (3.11 GB
of bf16 params and 9.33 GB of Yogi's m and v at 48), and the step peak
~35.8 GB, most of it the attention's f32 blocks (16 x 8 x 512 x 5 x 4096,
5.37 GB each) and the softmax backward's scratch: ~38 GB at 8 layers, ~51
GB planned at 48.
The last three lines are a JSON kernel report, the card's name and power
limit, and the JSON result line.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense

# tests/test_kernels.py SHAPES (P, D, K) plus the main-path shapes
SWEEP = [(1, 128, 2), (7, 33, 3), (128, 512, 8), (200, 300, 5), (1024, 256, 16),
         (64, 64, 64), (512, 128, 4), (64, 128, 2), (125, 6922, 7), (125, 1, 7),
         (64, 1, 2), (0, 128, 2), (33, 128, 1)]
# stage 2 at 32 and 64 cohorts (K = 63, 127), benchmarks/kernels_micro.py's
# shapes (8192 rows: two chunks of the segment kernel's row lists), a
# narrow call of 63 segments, wide rows, K = 400 (short segments: 4 pairs
# a thread), and rows past two chunks (9000, narrow and of 40 columns)
SWEEP_WIDE_K = [(125, 6922, 63), (125, 6922, 127), (1024, 256, 8), (4096, 256, 16),
                (8192, 512, 32), (300, 1, 63), (300, 6922, 7), (600, 40, 400), (9000, 40, 5),
                (9000, 1, 3)]
TOL = {"f32": 2e-5, "bf16": 2e-2}  # cosine
# tests/test_decode_attention_kernel.py shapes (B, H, Hkv, hd, S, length)
DECODE_SHAPES = [(2, 8, 2, 16, 64, 40), (1, 4, 4, 32, 128, 128), (3, 16, 2, 64, 300, 200),
                 (2, 8, 8, 128, 1024, 1)]
DECODE_TOL = {"f32": 2e-5, "bf16": 3e-2}
# the configs' larger groups (B, H, Hkv, hd): g = 5 (llama4-maverick), 12
# (starcoder2), 16 (qwen3-moe), at S with one split (512), two (520) and
# eight (4096) under plan_splits
GROUP_SHAPES = [(2, 40, 8, 128), (2, 48, 4, 128), (2, 64, 4, 128)]
GROUP_S = (512, 520, 4096)
# a long cache with ragged lengths, 0 (the mean of V over all S) and 1 among them
RAGGED = (4, 32, 8, 64, 16384, (0, 1, 9000, 16384))


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
    for (P, D, K) in SWEEP + SWEEP_WIDE_K:
        for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tcos = TOL[dname]
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
                for weighted, idt in ((False, torch.int64), (True, torch.int64),
                                      (False, torch.int32), (True, torch.int32)):
                    w = (torch.rand(lead + (P,), generator=g, device="cuda")
                         if weighted else None)
                    before = sa.launches
                    got = ops.segment_aggregate(x, ids.to(idt), K, w).cpu()
                    if P and sa.launches != before + 1:
                        raise AssertionError(f"segment {(P, D, K)}: a CUDA call did not launch")
                    # the plain version on a CPU copy: index_add_ in row
                    # order, the kernel's order (on the card index_add_
                    # adds by atomics, in no fixed order)
                    want = ref.segment_aggregate(x.cpu(), ids.cpu(), K, None if w is None else w.cpu())
                    err = (got - want).abs().max().item() if got.numel() else 0.0
                    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                        raise AssertionError(f"segment {dname} C={C} w={weighted} {idt} {(P, D, K)}: "
                                             f"not the plain version's bits (max err {err})")
                    worst["segment_aggregate"] = max(worst["segment_aggregate"], err)
    # run-to-run bit-identity of the fixed-order reductions: stage 2 at 7
    # and 63 segments, and both kernels at (8192, 512, 32)
    x = torch.randn(1, 125, 6922, generator=g, device="cuda")
    w = torch.rand(1, 125, generator=g, device="cuda")
    for K in (7, 63):
        ids = torch.randint(0, K, (1, 125), generator=g, device="cuda")
        if not torch.equal(ops.segment_aggregate(x, ids, K, w), ops.segment_aggregate(x, ids, K, w)):
            raise AssertionError(f"segment_aggregate at K={K} is not run-to-run identical")
    for dt in (torch.float32, torch.bfloat16):
        xb = torch.randn(8192, 512, generator=g, device="cuda").to(dt)
        cb = torch.randn(32, 512, generator=g, device="cuda").to(dt)
        ib = torch.randint(0, 32, (8192,), generator=g, device="cuda")
        if not torch.equal(ops.segment_aggregate(xb, ib, 32), ops.segment_aggregate(xb, ib, 32)):
            raise AssertionError(f"segment_aggregate {dt} (8192, 512, 32) is not run-to-run identical")
        if not torch.equal(ops.cosine_similarity(xb, cb), ops.cosine_similarity(xb, cb)):
            raise AssertionError(f"cosine_similarity {dt} (8192, 512, 32) is not run-to-run identical")
    del xb, cb, ib
    # a CUDA tensor never falls back: inputs the kernels do not take raise
    # (int64 ids are taken as they come; int16 ids are not)
    for bad in (lambda: cs.cosine_similarity(x.double(), x.double()),
                lambda: sa.segment_aggregate(x, ids.to(torch.int16), 7)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise AssertionError("a kernel wrapper accepted inputs it does not take")
    return worst


def check_decode(torch, ops, ref, da) -> float:
    """Phase 3b: decode attention against its plain version on the card:
    the JAX kernel tests' shapes, per-sequence lengths, length 0, a
    strided layer slice of a paged cache, the configs' groups of 5, 12 and
    16 heads on either side of the split threshold, and a ragged long
    cache; two launches bit-identical."""
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def check(what, q, k, v, n, tol):
        nonlocal worst
        before = da.launches
        got = ops.decode_attention(q, k, v, n)
        again = ops.decode_attention(q, k, v, n)
        want = ref.decode_attention(q, k, v, n)
        torch.cuda.synchronize()
        if da.launches != before + 2:
            raise AssertionError(f"decode {what}: a CUDA call did not launch the kernel")
        if not torch.equal(got, again):
            raise AssertionError(f"decode {what}: two launches differ")
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"decode {what}: max err {err} > {tol}")
        worst = max(worst, err)

    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tol = DECODE_TOL[dname]
        for (B, H, Hkv, hd, S, L) in DECODE_SHAPES:
            q, k, v = rnd(B, H, hd).to(dt), rnd(B, S, Hkv, hd).to(dt), rnd(B, S, Hkv, hd).to(dt)
            check(f"{dname} {(B, H, Hkv, hd, S, L)}", q, k, v, L, tol)
        q, k, v = rnd(4, 8, 32).to(dt), rnd(4, 256, 4, 32).to(dt), rnd(4, 256, 4, 32).to(dt)
        lens = torch.tensor([1, 64, 200, 256], device="cuda")
        check(f"{dname} per-sequence lengths", q, k, v, lens, tol)
        check(f"{dname} length 0", q, k, v, torch.tensor([0, 0, 3, 0], device="cuda"), tol)
        # one layer of a paged cache laid out (rows, lanes, L, S, Hkv, hd),
        # read in place through its batch and sequence strides
        cache_k = rnd(2, 4, 3, 256, 8, 64).to(dt)
        cache_v = rnd(2, 4, 3, 256, 8, 64).to(dt)
        kl = cache_k[:, :, 1].reshape(8, 256, 8, 64)
        vl = cache_v[:, :, 1].reshape(8, 256, 8, 64)
        if kl.is_contiguous() or kl.data_ptr() != cache_k[:, :, 1].data_ptr():
            raise AssertionError("the layer slice should be a strided view")
        lens = torch.randint(1, 257, (8,), generator=g, device="cuda")
        check(f"{dname} strided layer slice", rnd(8, 32, 64).to(dt), kl, vl, lens, tol)
        for (B, H, Hkv, hd) in GROUP_SHAPES:
            for S in GROUP_S:
                q, k, v = rnd(B, H, hd).to(dt), rnd(B, S, Hkv, hd).to(dt), rnd(B, S, Hkv, hd).to(dt)
                lens = torch.tensor([S, S // 2 + 3], device="cuda")
                check(f"{dname} g={H // Hkv} {(B, H, Hkv, hd, S)}", q, k, v, lens, tol)
        B, H, Hkv, hd, S, lens = RAGGED
        q, k, v = rnd(B, H, hd).to(dt), rnd(B, S, Hkv, hd).to(dt), rnd(B, S, Hkv, hd).to(dt)
        check(f"{dname} ragged long cache {(B, H, Hkv, hd, S)} lengths {lens}", q, k, v,
              torch.tensor(lens, device="cuda"), tol)
        del q, k, v
    # a CUDA tensor never falls back: inputs the kernel does not take raise
    q, k = rnd(2, 8, 48), rnd(2, 16, 2, 48)
    n = torch.ones(2, dtype=torch.int32, device="cuda")
    for bad in (lambda: da.decode_attention(q.double(), k.double(), k.double(), n),
                lambda: da.decode_attention(q, k, k, n)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise AssertionError("the decode wrapper accepted inputs it does not take")
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


def run_main(torch, rounds: int, devices=None, **fl_kw):
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, FLConfig, MLPTask, run_auxo

    pop = make_population(**POP)
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    fl = FLConfig(rounds=rounds, participants_per_round=100,
                  eval_every=max(2, rounds // 20), use_availability=True, seed=1, **fl_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, hist = run_auxo(task, pop, fl, AuxoConfig(**AUXO), device="cuda", devices=devices)
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
    return pg, err, engs


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


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


L2_BYTES = 50e6  # H100 L2: rows whose bound is HBM bytes rotate over more than twice this


def rotating(fn, inputs):
    """One call of fn per call, on the next of the input tuples in turn."""
    i = [0]

    def call():
        r = fn(*inputs[i[0] % len(inputs)])
        i[0] += 1
        return r

    return call


def time_calls(torch, kernel, plain, library, inputs, nbytes, flops, peak=FP32_FLOPS,
               inner: int = 20, reps: int = 25):
    """Kernel (graph and eager), plain version and library call on the same
    rotating inputs: each graph holds at least one call per input copy."""
    inner = max(inner, len(inputs))
    return dict(
        ms=graph_ms(torch, rotating(kernel, inputs), inner, reps),
        eager_ms=eager_ms(torch, rotating(kernel, inputs), inner, reps),
        plain_ms=graph_ms(torch, rotating(plain, inputs), inner, reps),
        library_ms=None if library is None else graph_ms(torch, rotating(library, inputs), inner, reps),
        bound=bound(nbytes, flops, peak),
    )


def n_copies(nbytes: float, rotate: bool) -> int:
    return max(2, math.ceil(2 * L2_BYTES / nbytes)) if rotate else 1


def time_cosine(torch, ops, ref, sig, rotate: bool = False):
    """sig: (x shape, c shape, dtype). The bound takes the tensor-core peak
    for bf16 (the card could run the product there)."""
    (xs, cs_shape, dt) = sig
    C, P, D = xs
    K = cs_shape[1]
    el = torch.empty((), dtype=dt).element_size()
    nbytes = C * (P * D + K * D) * el + C * P * K * 4
    flops = C * (2 * P * K * D + 2 * P * D + 2 * K * D)
    ins = [(torch.randn(xs, device="cuda").to(dt), torch.randn(cs_shape, device="cuda").to(dt))
           for _ in range(n_copies(nbytes, rotate))]
    F = torch.nn.functional
    lib = lambda x, c: F.cosine_similarity(x.unsqueeze(-2), c.unsqueeze(-3), dim=-1)  # noqa: E731
    out = time_calls(torch, ops.cosine_similarity, ref.cosine_similarity, lib, ins, nbytes, flops,
                     FP32_FLOPS if dt == torch.float32 else BF16_FLOPS)
    del ins
    torch.cuda.empty_cache()
    return out


def time_segment(torch, ops, ref, sig, rotate: bool = False, id_dtype=None,
                 inner: int = 20, reps: int = 25):
    """sig: (data shape, K, dtype, weighted); ids in [0, K) of ``id_dtype``
    (int64, as stage 2 passes them, unless given). The library call, where
    one computes the function (C = 1), is ``index_add_`` into an output of
    the data's dtype (unweighted), ``w @ d`` (one weighted segment) or
    ``M @ d`` (K weighted segments; M the (K, P) weighted one-hot of the
    ids, built outside the timed call)."""
    (ds, K, dt, weighted) = sig
    C, P, D = ds
    lead = ds[:-1]
    id_dtype = id_dtype or torch.int64
    el = torch.empty((), dtype=dt).element_size()
    id_el = torch.empty((), dtype=id_dtype).element_size()
    nbytes = C * P * D * el + C * P * (id_el + (4 if weighted else 0)) + C * K * D * 4
    ins = []
    for _ in range(n_copies(nbytes, rotate)):
        ids = torch.randint(0, K, lead, device="cuda", dtype=id_dtype)
        w = torch.rand(lead, device="cuda") if weighted else None
        ins.append((torch.randn(ds, device="cuda").to(dt), ids, K, w))
    flops = P * C * D * (2 if weighted else 1)  # every id is in [0, K): every row is summed
    library = None
    if not weighted and C == 1:  # one call computes the unweighted sum
        outs = {id(i[0]): torch.zeros(K, D, dtype=dt, device="cuda") for i in ins}
        library = lambda d, i, k, w: outs[id(d)].index_add_(0, i[0], d[0])  # noqa: E731
    elif weighted and K == 1 and C == 1:
        library = lambda d, i, k, w: torch.matmul(w[0], d[0])  # noqa: E731
    elif weighted and C == 1:
        onehot = {id(d): torch.zeros(K, P, device="cuda").scatter_(0, i[0][None].long(), w[0][None]).to(dt)
                  for d, i, _, w in ins}
        library = lambda d, i, k, w: torch.matmul(onehot[id(d)], d[0])  # noqa: E731
    out = time_calls(torch, ops.segment_aggregate, ref.segment_aggregate, library, ins, nbytes, flops,
                     inner=inner, reps=reps)
    del ins
    torch.cuda.empty_cache()
    return out


# rows phase 6 times besides the main run's own call shapes: the main
# path's representative calls (stage 2 at 7 segments and its D = 1
# denominator, the clustering cosine), stage 2 at 63 segments (32
# cohorts), and benchmarks/kernels_micro.py's shapes, unweighted, C = 1,
# rotated past the L2 (their bound is HBM bytes)
MICRO = [(1024, 256, 8), (4096, 256, 16), (8192, 512, 32)]


def fixed_rows(torch):
    f32, bf16 = torch.float32, torch.bfloat16
    rows = [("segment_aggregate", "stage2_k7", ((1, 125, 6922), 7, f32, True), False),
            ("segment_aggregate", "stage2_denominator_d1", ((1, 125, 1), 7, f32, False), False),
            ("segment_aggregate", "stage2_k63", ((1, 125, 6922), 63, f32, True), False),
            ("cosine_similarity", "clustering_main", ((4, 64, 128), (4, 2, 128), f32), False)]
    for (P, D, K) in MICRO:
        for dname, dt in (("f32", f32), ("bf16", bf16)):
            rows.append(("segment_aggregate", f"micro_{P}_{D}_{K}_{dname}", ((1, P, D), K, dt, False), True))
            rows.append(("cosine_similarity", f"micro_{P}_{D}_{K}_{dname}", ((1, P, D), (1, K, D), dt), True))
    return rows


# the LM path's aggregation at granite-3-2b's smallest and largest leaf
# shapes of phase 10 (1, 2, n) -> 1 weighted, int32 ids: ``--kernel-timing``
# times them besides phase 6's rows
LM_TIMING = [41_943_040, 671_088_640]


def time_fixed_rows(torch, ops, ref, lm: bool = False):
    """Phase 6's fixed rows (and, with ``lm``, the LM_TIMING rows):
    [(kernel, key, sig, times)]."""
    out = []
    rows = fixed_rows(torch) + ([("segment_aggregate", f"lm_1_2_{n}_k1_w", ((1, 2, n), 1, torch.float32, True),
                                  False) for n in LM_TIMING] if lm else [])
    for name, key, sig, rotate in rows:
        if name == "cosine_similarity":
            t = time_cosine(torch, ops, ref, sig, rotate)
        elif key.startswith("lm_"):
            t = time_segment(torch, ops, ref, sig, id_dtype=torch.int32, inner=3, reps=5)
        else:
            t = time_segment(torch, ops, ref, sig, rotate)
        out.append((name, key, sig, t))
        print_row(name, f"{key} {sig}", t)
    return out


def print_row(name, what, t):
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.5f}"
    print(f"[timing] {name} {what}: kernel {t['ms']:.5f} ms (eager {t['eager_ms']:.5f}), plain "
          f"{t['plain_ms']:.5f}, library {lib}, bound {t['bound'][0]:.6f} ms ({t['bound'][1]}) = "
          f"{100 * t['bound'][0] / t['ms']:.1f}% of bound", flush=True)


def time_decode(torch, ops, ref, q, k, v, lens, inner: int = 20, reps: int = 25,
                plain_inner: int = 20):
    """One decode-attention call: kernel, plain version and one library
    call (``scaled_dot_product_attention`` with a length mask, timed only
    as a yardstick), beside the byte bound of the valid prefixes. Large
    calls take fewer graph replays (``inner``, ``reps``), and the plain
    version, whose float32 copies of K and V each graph holds, fewer
    calls per graph (``plain_inner``)."""
    B, H, hd = q.shape
    Hkv = k.shape[2]
    el = q.element_size()
    n_tok = int(lens.sum())
    nbytes = 2 * B * H * hd * el + 2 * n_tok * Hkv * hd * el + B * 4
    flops = 4 * H * hd * n_tok
    F = torch.nn.functional
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(k.shape[1], device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)  # noqa: E731
    pr = max(3, reps * plain_inner // inner)
    out = dict(
        ms=graph_ms(torch, lambda: ops.decode_attention(q, k, v, lens), inner, reps),
        eager_ms=eager_ms(torch, lambda: ops.decode_attention(q, k, v, lens), inner, reps),
        plain_ms=graph_ms(torch, lambda: ref.decode_attention(q, k, v, lens), plain_inner, pr),
        library_ms=graph_ms(torch, lib, inner, reps),
        bound=bound(nbytes, flops, FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS),
    )
    torch.cuda.empty_cache()
    return out


U32 = 2.0 ** -24  # float32 unit roundoff
NOISE_FACTOR = 8  # the tolerance of the main-path check, in units of attention_noise


def attention_noise(torch, q, k, v, length):
    """Decode attention in float64 on the same inputs, and the float32
    rounding it carries at these inputs, per output element. A score
    s_t = q.k_t / sqrt(hd) sums hd products: float32 rounds it by about
    u * sum_i |q_i k_ti| / sqrt(hd). The softmax passes that on as
    d out / d s_t = p_t (v_t - out), and the output's own rounding adds
    u * max|v|. Returns (exact, noise), both (B, H, hd) float64."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, Hkv, H // Hkv, hd)
    k64, v64 = k.double(), v.double()
    s = torch.einsum("bngk,bsnk->bngs", qg, k64) / math.sqrt(hd)
    a = torch.einsum("bngk,bsnk->bngs", qg.abs(), k64.abs()) / math.sqrt(hd)
    valid = torch.arange(S, device=q.device)[None, :] < length[:, None]
    p = torch.softmax(s.masked_fill(~valid[:, None, None, :], -1e30), dim=-1)
    exact = torch.einsum("bngs,bsnk->bngk", p, v64)
    dev = (v64.permute(0, 2, 1, 3)[:, :, None] - exact[:, :, :, None]).abs()
    vmax = v64.abs().masked_fill(~valid[:, :, None, None], 0).amax()
    noise = U32 * (torch.einsum("bngs,bngsk->bngk", p * a, dev) + vmax)
    return exact.reshape(B, H, hd), noise.reshape(B, H, hd)


def checking_attend(torch, ops, ref, log: list):
    """The main path's decode attention: the kernel's output, held against
    the plain version on the same q, K, V and lengths at every call (every
    layer of every step). The tolerance is the f32 one of phase 3b plus
    NOISE_FACTOR times the float32 rounding of these inputs
    (``attention_noise``): with random full-width weights the scores reach
    |s| ~ 300, and two correct float32 versions that sum in another order
    then differ by ~1e-4. Each call logs its max |err| against the plain
    version and the kernel's and the plain version's against float64."""
    tol = DECODE_TOL["f32"]

    def attend(q, k, v, length):
        got = ops.decode_attention(q, k, v, length)
        want = ref.decode_attention(q, k, v, length)
        exact, noise = attention_noise(torch, q, k, v, length)
        diff = (got - want).abs().double()
        share = diff / (tol + tol * want.abs() + NOISE_FACTOR * noise)
        err = diff.max().item()
        if (share > 1).any():
            raise AssertionError(f"decode attention call {len(log)} of the main path: kernel vs "
                                 f"plain max err {err}, beyond the tolerance at "
                                 f"{int((share > 1).sum())} elements")
        log.append((err, (got.double() - exact).abs().max().item(),
                    (want.double() - exact).abs().max().item(), share.max().item()))
        return got

    return attend


GRANITE = "granite-3-2b"
DECODE_LANES, DECODE_PAGE, DECODE_STEPS = 4, 128, 16


def decode_phase(torch, np, ops, ref, profile: bool = False):
    """Phase 7: paged cohort decode at granite-3-2b's full width. The kernel
    decoder's every attention call is checked against the plain version
    (``checking_attend``); a plain-backend decoder runs beside it, fed the
    plain decoder's greedy tokens at every step (teacher-forced, so the two
    never part), and the token streams and logits are compared. With
    ``profile``, a torch.profiler window over one 4-step decode call."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import build_model
    from repro_torch.serve import CohortDecoder

    model = build_model(get_config(GRANITE))
    cfg = model.cfg
    n_params = model.param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bank = model.init_bank(rnd.key(0), 3, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    bank_gb = torch.cuda.memory_allocated() / 1e9
    live = [0, 1]
    calls = []
    dk, dr = (CohortDecoder(model, lambda: bank, lambda: list(live), lanes=DECODE_LANES,
                            page_size=DECODE_PAGE, backend=b, device="cuda")
              for b in (checking_attend(torch, ops, ref, calls), "ref"))
    logit_errs, max_err, tie_steps, step = [], 0.0, [], 0
    da.launches = 0
    for phase_live in ([0, 1], [1, 2]):  # [1, 2]: slot 0 partitions away
        live[:] = phase_live
        for _ in range(DECODE_STEPS):
            (tk, lk), (tr, lr) = dk.decode(1), dr.decode(1)
            step += 1
            if dk.cache.slots != dr.cache.slots:
                raise AssertionError("decode: the backends hold different cohort rows")
            logit_errs.append(float(np.abs(lk - lr).max()))
            max_err = max(max_err, logit_errs[-1])
            differ = tk[..., 0] != tr[..., 0]
            if differ.any():
                top2 = np.sort(lr, axis=-1)[..., -2:]
                gap = (top2[..., 1] - top2[..., 0])[differ]
                if not (gap < max_err).all():
                    raise AssertionError(
                        f"decode step {step}: tokens differ with a top-2 gap {gap.min()} "
                        f"above the max logit error {max_err}")
                tie_steps.append((step, int(differ.sum())))
            dk.tokens = dr.tokens  # teacher-forced: both go on from the plain tokens
    launches = da.launches
    torch.cuda.synchronize()
    n_steps = 2 * DECODE_STEPS
    if launches != cfg.n_layers * n_steps or len(calls) != launches:
        raise AssertionError(f"decode: {launches} kernel launches and {len(calls)} checked "
                             f"calls, want {cfg.n_layers} x {n_steps}")
    idx = dict(zip(dk.cache.slots, dk.cache.index.tolist()))
    if 0 in idx or idx.get(1) != n_steps or idx.get(2) != DECODE_STEPS:
        raise AssertionError(f"decode: partition scatter kept positions {idx}")
    lens = torch.from_numpy(dk.cache.index.astype(np.int64)).repeat_interleave(DECODE_LANES)
    del dk, dr
    # throughput: a fresh kernel decoder; the per-step time is the
    # difference of a 1-step and a 16-step call (the gather cancels)
    live[:] = [0, 1]
    dt = CohortDecoder(model, lambda: bank, lambda: list(live), lanes=DECODE_LANES,
                       page_size=DECODE_PAGE, device="cuda")
    walls = []
    for n in (1, DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = dt.decode(n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not np.isfinite(logits).all() or toks.shape != (2, DECODE_LANES, DECODE_STEPS):
        raise AssertionError("decode: non-finite logits or a wrong token shape")
    step_ms = (walls[1] - walls[0]) / (DECODE_STEPS - 1) * 1e3
    table = None
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dt.decode(4)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        evs = prof.key_averages()
        busy = sum(e.self_device_time_total for e in evs if e.device_type == DeviceType.CUDA) / 1e6
        table = (f"{evs.table(sort_by='self_device_time_total', row_limit=15)}\n[profile] one "
                 f"4-step decode call (params gather included): wall {wall:.4f} s under the "
                 f"profiler, device busy {busy:.6f} s = {100 * busy / wall:.2f}% of the wall")
    row_bytes = n_params * 4
    bound_ms = 2 * row_bytes / HBM_BYTES_PER_S * 1e3
    out = dict(
        launches=launches, n_steps=n_steps, max_err=max_err, tie_steps=tie_steps,
        logit_errs=logit_errs, call_err=[max(c[i] for c in calls) for i in range(4)],
        init_s=t_init, bank_gb=bank_gb,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        call_tok_s=2 * DECODE_LANES * DECODE_STEPS / walls[1],
        step_tok_s=2 * DECODE_LANES / (step_ms / 1e3), step_ms=step_ms,
        bound_ms=bound_ms, n_params=n_params, n_layers=cfg.n_layers, lens=lens, table=table,
    )
    del dt, bank
    torch.cuda.empty_cache()
    return out


def serving_phase(torch, np, eng):
    """Phase 8: a burst through the serving plane on the main run's engine."""
    from repro_torch.serve import QueryStream, ServingPlane, StreamConfig

    ids = np.arange(eng.data.n_clients, dtype=np.int64)
    hot = ids[np.asarray(eng.fp_seen[ids], bool)]
    cold = np.setdiff1d(ids, hot)
    if not (hot.size and cold.size and len(eng.coordinator.identity) >= 2):
        raise AssertionError(f"serving: {hot.size} hot, {cold.size} cold clients, "
                             f"{len(eng.coordinator.identity)} identities")
    plane = ServingPlane(eng, max_batch=256)
    stream = QueryStream(StreamConfig(n_queries=2000, hot_frac=0.9, seed=0), hot, cold)
    d0 = eng.probe_train_dispatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds, batches = plane.serve_stream(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    probes = eng.probe_train_dispatches - d0
    if plane.infer_dispatches != len(batches) or probes > len(batches):
        raise AssertionError(f"serving: {plane.infer_dispatches} inferences and {probes} probe "
                             f"batches for {len(batches)} admitted batches")
    if preds.size != 2000 or preds.min() < 0 or preds.max() >= eng.data.n_classes:
        raise AssertionError("serving: predictions out of range")
    batch = cold[:64]
    plane.serve_batch(batch)
    d1 = eng.probe_train_dispatches
    again = plane.serve_batch(batch)
    if eng.probe_train_dispatches != d1:
        raise AssertionError("serving: a repeated cold batch probed again")
    if not np.array_equal(again, plane.serve_batch(batch)):
        raise AssertionError("serving: a repeated batch changed its answers")
    slots = plane.route_slots(ids)
    return dict(wall=wall, qps=2000 / wall, batches=len(batches), probes=probes, hot=hot.size,
                cold=cold.size, slots=sorted(set(slots.tolist())))


def record(mod, name, sig, log, torch=None):
    """Log each call of ``mod.name`` by ``sig(*args)`` (the wrapper's own
    count is untouched): into a dict, a count per signature; into a list,
    the signatures in call order, or with ``torch`` (signature, start, end)
    CUDA events around each call (no synchronisation). Returns the undo."""
    orig = getattr(mod, name)

    def rec(*a, **k):
        key = sig(*a, **k)
        if isinstance(log, dict):
            log[key] = log.get(key, 0) + 1
            return orig(*a, **k)
        if torch is None:
            log.append(key)
            return orig(*a, **k)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = orig(*a, **k)
        t1.record()
        log.append((key, t0, t1))
        return out

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


LONG_S = 32768
MAIN_LENS = (2 * DECODE_STEPS,) * DECODE_LANES + (DECODE_STEPS,) * DECODE_LANES


def decode_timing(torch, ops, ref):
    """Phase 9: decode attention timed at the main path's call (one layer of
    the paged cache at the last step's lengths, read in place), at a 32k
    cache of 8 sequences (full, f32 and bf16; ragged, bf16) and at the
    ``decode_32k`` batch (128 sequences of 32k, bf16). Every row but the
    main-path call is first held against the plain version. Returns
    [(report key, name, times)] in that order."""
    from repro_torch.kernels import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(2)
    H, Hkv, hd = 32, 8, 64  # granite-3-2b
    rows = []
    if hasattr(da, "blocks_per_sm"):  # an earlier package (--src) may not plan by occupancy
        sms = da.sm_count(0)
        for dt in (torch.float32, torch.bfloat16):
            per_sm = da.blocks_per_sm(0, hd, H // Hkv, dt)
            plans = {f"B={B} S={S}": da.plan_splits(B, Hkv, S, sms, per_sm)
                     for B, S in ((len(MAIN_LENS), DECODE_PAGE), (8, LONG_S), (128, LONG_S))}
            print(f"[occupancy] decode split kernel, {dt}, hd {hd}, g {H // Hkv}: {per_sm} "
                  f"resident blocks per SM x {sms} SMs; (n_split, chunk) {plans}")

    def timed(key, name, q, k, v, n, check=True, **kw):
        if check:
            tol = DECODE_TOL["f32" if q.dtype == torch.float32 else "bf16"]
            got, want = ops.decode_attention(q, k, v, n), ref.decode_attention(q, k, v, n)
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                raise AssertionError(f"decode {name}: kernel and plain differ by {err}")
            del got, want
            torch.cuda.empty_cache()
        t = time_decode(torch, ops, ref, q, k, v, n, **kw)
        rows.append((key, name, t))
        print(f"[timing] decode_attention {name}: kernel {t['ms']:.5f} ms (eager "
              f"{t['eager_ms']:.5f}), plain {t['plain_ms']:.5f}, library (sdpa) "
              f"{t['library_ms']:.5f}, bound {t['bound'][0]:.6f} ms ({t['bound'][1]}) = "
              f"{100 * t['bound'][0] / t['ms']:.1f}% of bound", flush=True)

    # (rows, lanes, L, S, Hkv, hd), lanes before layers as in serve/kv_cache.py
    ck = torch.randn(2, DECODE_LANES, 40, DECODE_PAGE, Hkv, hd, generator=g, device="cuda")
    cv = torch.randn(2, DECODE_LANES, 40, DECODE_PAGE, Hkv, hd, generator=g, device="cuda")
    lens = torch.tensor(MAIN_LENS, dtype=torch.int32, device="cuda")
    B = lens.numel()
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
        kl, vl = ck[:, :, 0].to(dt), cv[:, :, 0].to(dt)  # f32: the strided view itself
        timed(f"main_path_{dname}", f"main-path call {dname} (B={B}, S={DECODE_PAGE}, "
              f"lengths {list(MAIN_LENS)})", q, kl.reshape(B, DECODE_PAGE, Hkv, hd),
              vl.reshape(B, DECODE_PAGE, Hkv, hd), lens, check=False)
    del ck, cv
    full = torch.full((B,), LONG_S, dtype=torch.int32, device="cuda")
    ragged = torch.linspace(4096, LONG_S, B, device="cuda").round().to(torch.int32)
    for key, dname, dt, n in (("long_cache_f32", "f32", torch.float32, full),
                              ("long_cache_bf16", "bf16", torch.bfloat16, full),
                              ("ragged_bf16", "bf16", torch.bfloat16, ragged)):
        q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, LONG_S, Hkv, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, LONG_S, Hkv, hd, generator=g, device="cuda").to(dt)
        what = "full" if n is full else f"ragged lengths {n.tolist()}"
        timed(key, f"long cache {dname} (B={B}, S={LONG_S}, {what})", q, k, v, n)
        del q, k, v
    # src/repro/configs/shapes.py decode_32k: 128 sequences of 32768, granite heads
    B = 128
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.empty(B, LONG_S, Hkv, hd, dtype=torch.bfloat16, device="cuda")
    v = torch.empty_like(k)
    for t in (k, v):  # drawn a sequence at a time: no float32 copy of 4.3 GB
        for b in range(B):
            t[b] = torch.randn(LONG_S, Hkv, hd, generator=g, device="cuda")
    n = torch.full((B,), LONG_S, dtype=torch.int32, device="cuda")
    timed("decode_32k_bf16", f"decode_32k bf16 (B={B}, S={LONG_S}, full)", q, k, v, n,
          inner=5, reps=10, plain_inner=1)
    del q, k, v
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------- phase 10: LM training
LM_ROUNDS = 3
LM_C, LM_M, LM_S = 2, 2, 512  # clients, sequences per client, tokens per sequence
LM_TOL = dict(rtol=1e-4, atol=1e-5)  # plus twice float32's own error on the leaf (10a)


def synth_corpus(n_clients, m, seq, vocab, n_groups=2, phrase=64, noise=0.05):
    """examples/train_lm_federated.py's corpus: each group repeats its own
    random phrase and clients add token-substitution noise; client c is in
    group c % n_groups. numpy, seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    phrases = [rng.integers(0, vocab, size=phrase) for _ in range(n_groups)]
    toks = np.zeros((n_clients, m, seq), np.int32)
    groups = np.arange(n_clients) % n_groups
    for c in range(n_clients):
        base = phrases[groups[c]]
        for j in range(m):
            off = rng.integers(0, phrase)
            row = np.tile(base, seq // phrase + 2)[off: off + seq].copy()
            flip = rng.random(seq) < noise
            row[flip] = rng.integers(0, vocab, size=flip.sum())
            toks[c, j] = row
    return toks, groups


def forbid_cuda_in_plain(torch, ref):
    """The plain kernel versions raise on a CUDA tensor while this is in
    force (a CUDA tensor must reach the kernels only); returns the undo."""
    names = ("segment_aggregate", "cosine_similarity", "decode_attention")
    origs = {n: getattr(ref, n) for n in names}

    def guard(name, fn):
        def g(*a, **k):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in list(a) + list(k.values())):
                raise AssertionError(f"a CUDA tensor reached the plain {name}")
            return fn(*a, **k)
        return g

    for n, f in origs.items():
        setattr(ref, n, guard(n, f))
    return lambda: [setattr(ref, n, f) for n, f in origs.items()]


def lm_small_reference(torch, np):
    """Phase 10a: 3 rounds of make_train_step on a reduced granite-3-2b on
    the card and on the CPU from the same params and tokens."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves_with_path, tree_map

    cfg = reduce_config(get_config(GRANITE)).replace(attn_qchunk=8, ce_chunk=8)
    sc = steps.StepConfig(local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32)
    init = build_model(cfg).init(rnd.key(0), device="cpu")
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab, (4, 4, 16)).astype(np.int32) for _ in range(LM_ROUNDS)]
    runs = {}
    # the card, the CPU, and the CPU in float64: float32's own error on each
    # leaf, which the card-vs-CPU comparison allows twice over
    for run, dev, dt in (("cpu", "cpu", torch.float32), ("cuda", "cuda", torch.float32),
                         ("cpu64", "cpu", torch.float64)):
        ids, counts = [], []  # every segment call's (K, D, ids): the assignments at K 2
        undo = record(steps.kops, "segment_aggregate",
                      lambda d, i, k, w=None: (int(k), d.shape[-1], i.cpu()), ids)
        params = tree_map(lambda a: a.to(dev, dt, copy=True), init)
        opt, clust = steps.yogi_init(params), steps.clustering_init(2, 32, device=dev)
        step = steps.make_train_step(build_model(cfg.replace(dtype=dt)), sc)
        sa.launches = 0
        for t in toks:
            params, opt, clust, met = step(params, opt, clust, {"tokens": torch.from_numpy(t).to(dev)})
            counts.append(met["cluster_counts"].cpu())
        undo()
        runs[run] = (params, opt, clust, ids, counts, sa.launches)
    (pg, og, cg, ig, ng, launches), (pc, oc, cc, ic, nc, _) = runs["cuda"], runs["cpu"]
    if launches != LM_ROUNDS * (2 + len(leaves_with_path(pg))) or len(ig) != launches:
        raise AssertionError(f"lm 10a: {launches} segment kernel launches, {len(ig)} calls")
    ag = [i[0] for k, d, i in ig if k > 1 and d > 1]
    if ([(k, d) for k, d, _ in ig] != [(k, d) for k, d, _ in ic]
            or not all(torch.equal(a[2], b[2]) for a, b in zip(ig, ic))
            or not all(torch.equal(a, b) for a, b in zip(ng, nc))):
        raise AssertionError(f"lm 10a: assignments differ card {ag} vs CPU "
                             f"{[i[0] for k, d, i in ic if k > 1 and d > 1]}")
    errs, floors = {}, {}
    for i, name in enumerate(("params", "opt", "clust")):
        cpu = dict(leaves_with_path(runs["cpu"][i]))
        f64 = dict(leaves_with_path(runs["cpu64"][i]))
        for k, v in leaves_with_path(runs["cuda"][i]):
            err = (v.cpu() - cpu[k]).abs().max().item()
            floor = (cpu[k].double() - f64[k].double()).abs().max().item()
            errs[name] = max(errs.get(name, 0.0), err)
            floors[name] = max(floors.get(name, 0.0), floor)
            if not torch.allclose(v.cpu(), cpu[k], rtol=LM_TOL["rtol"], atol=LM_TOL["atol"] + 2 * floor):
                raise AssertionError(f"lm 10a: {name} {k} differs card vs CPU by {err} (float32's "
                                     f"own error there: {floor})")
    return dict(errs=errs, floors=floors, launches=launches, assign=[a.tolist() for a in ag],
                counts=[c.tolist() for c in ng])


def lm_train_phase(torch):
    """Phases 10b and 10c: granite-3-2b at full width and depth (float32),
    3 federated rounds of make_train_step with 2 clients, then 2 centralized
    steps, a prefill and 8 served tokens."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.core.sketch import GradientSketcher
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves

    model = build_model(get_config(GRANITE))
    cfg = model.cfg
    n_params = model.param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(rnd.key(0), device="cuda")
    opt = steps.yogi_init(params)
    clust = steps.clustering_init(2, 128, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sc = steps.StepConfig(local_steps=2, d_sketch=128)
    step = steps.make_train_step(model, sc)
    toks_np, groups = synth_corpus(LM_C, LM_M, LM_S, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks_np).cuda()}
    sk_log, agg_log = [], []
    undo = [record(GradientSketcher, "batch", lambda self, u: "sketch", sk_log, torch),
            record(steps.kops, "segment_aggregate",
                   lambda d, i, k, w=None: (tuple(d.shape), int(k), w is not None), agg_log, torch)]
    secs, losses, counts = [], [], []
    sa.launches = 0
    try:
        for _ in range(LM_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, clust, met = step(params, opt, clust, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            counts.append(met["cluster_counts"].tolist())
    finally:
        for u in undo:
            u()
    launches = sa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaves = len(leaves(params))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"lm 10b: non-finite loss {losses}")
    if not all(bool(torch.isfinite(a).all()) for a in leaves(params)):
        raise AssertionError("lm 10b: non-finite params")
    if any(sum(c) != LM_C for c in counts):
        raise AssertionError(f"lm 10b: cluster counts {counts} do not sum to {LM_C}")
    if launches != LM_ROUNDS * (2 + n_leaves) or len(agg_log) != launches:
        raise AssertionError(f"lm 10b: {launches} segment kernel launches and {len(agg_log)} "
                             f"calls, want {LM_ROUNDS} x (2 + {n_leaves})")
    sk_ms = [a.elapsed_time(b) for _, a, b in sk_log]
    agg = {}
    for sig, a, b in agg_log:
        agg.setdefault(sig, []).append(a.elapsed_time(b))
    tokens = LM_C * LM_M * LM_S
    flops = 8 * n_params * tokens  # forward, backward and the forward recompute
    # the sketch reads each client's last block once and multiplies it by
    # (block, 128) matrices it draws (7.8G draws a round, not counted here)
    n_last = sum(a[-1].numel() for a in leaves(params["backbone"])) + cfg.d_model
    sk_bound = bound(LM_C * n_last * 4, 2 * LM_C * n_last * sc.d_sketch)

    # ------------------------------------------------------------- 10c
    central = steps.make_central_train_step(model, sc, n_clients=4)
    ctoks = torch.from_numpy(synth_corpus(4, 1, LM_S, cfg.vocab)[0].reshape(4, LM_S)).cuda()
    cclust = steps.clustering_init(2, 128, device="cuda")
    closs = []
    for _ in range(2):
        params, opt, cclust, cmet = central(params, opt, cclust, {"tokens": ctoks})
        closs.append(float(cmet["loss"]))
    if not all(math.isfinite(v) for v in closs) or not all(bool(torch.isfinite(a).all()) for a in leaves(params)):
        raise AssertionError(f"lm 10c: central steps not finite (loss {closs})")
    prompt = batch["tokens"][:, 0]  # (2, 512): each client's first sequence
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = steps.make_prefill_step(model, sc)(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if tuple(last.shape) != (2, 1, cfg.vocab) or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"lm 10c: prefill logits {tuple(last.shape)} not finite")
    serve = steps.make_serve_step(model, sc)
    cache = model.init_cache(2, 1024, device="cuda")
    cur = prompt[:, :1]
    served = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        logits, cache = serve(params, cache, {"tokens": cur})
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("lm 10c: non-finite serve logits")
        cur = torch.argmax(logits, dim=-1)
        served.append(cur[:, 0].tolist())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if cache["blocks"]["index"].tolist() != [8] * cfg.n_layers:
        raise AssertionError(f"lm 10c: cache index {cache['blocks']['index'].tolist()}")
    peak_all = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, cache, central, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, n_layers=cfg.n_layers, init_s=init_s, secs=secs, losses=losses,
                counts=counts, groups=groups.tolist(), launches=launches, n_leaves=n_leaves,
                peak_gb=peak_gb, peak_all_gb=peak_all, tokens=tokens, flops=flops, sk_ms=sk_ms,
                sk_bound=sk_bound, n_last=n_last, agg=agg, closs=closs, prefill_s=prefill_s,
                serve_s=serve_s, served=served)


def check_rows(torch, ops, ref, cos_sigs, seg_sigs, id_dtype=None) -> dict:
    """Call shapes (phase 6's sigs) of the round kernels held against the
    plain version on the same random inputs: the cosine at 2e-5, the
    segment sums bit-equal to the plain version on a CPU copy (``index_add_``
    in row order; on the card ``index_add_`` adds by atomics, in no fixed
    order); segment ids of ``id_dtype`` (int64 unless given; the LM step
    passes int32). Each input is freed before the next (the LM rows reach
    5.4 GB). Returns the largest error per kernel."""
    g = torch.Generator(device="cuda").manual_seed(3)
    worst = {"cosine_similarity": 0.0, "segment_aggregate": 0.0}
    for xs, cs_shape, dt in cos_sigs:
        x = torch.randn(xs, generator=g, device="cuda").to(dt)
        c = torch.randn(cs_shape, generator=g, device="cuda").to(dt)
        got, want = ops.cosine_similarity(x, c), ref.cosine_similarity(x, c)
        if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
            raise AssertionError(f"cosine at the shape {xs} x {cs_shape}")
        worst["cosine_similarity"] = max(worst["cosine_similarity"], (got - want).abs().max().item())
    for ds, K, dt, weighted in seg_sigs:
        d = torch.randn(ds, generator=g, device="cuda", dtype=dt)
        ids = torch.randint(0, K, ds[:-1], generator=g, device="cuda", dtype=id_dtype or torch.int64)
        w = torch.rand(ds[:-1], generator=g, device="cuda") if weighted else None
        got = ops.segment_aggregate(d, ids, K, w).cpu()
        want = ref.segment_aggregate(d.cpu(), ids.cpu(), K, None if w is None else w.cpu())
        err = (got - want).abs().max().item()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"segment at the shape {ds} K {K}: not the plain version's bits "
                                 f"(max err {err})")
        worst["segment_aggregate"] = max(worst["segment_aggregate"], err)
        del d, ids, w, got, want
        torch.cuda.empty_cache()
    return worst


def lm_row_sigs(n_params_by_leaf, C, d_sketch, k, dt):
    """The LM path's distinct segment call shapes (time_segment's sig): each
    leaf's aggregation (1, C, n) into one weighted segment, largest first,
    then the clustering sums (1, C, d_sketch) and counts (1, C, 1) into k."""
    sizes = sorted(set(n_params_by_leaf), reverse=True)
    return ([((1, C, n), 1, dt, True) for n in sizes]
            + [((1, C, d_sketch), k, dt, False), ((1, C, 1), k, dt, False)])


def run_lm_phase(torch, np, ops, ref):
    """Phase 10 (after phase 9 has freed its memory): 10a card vs CPU, 10b
    and 10c at granite-3-2b's full width, then the LM path's segment rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    undo = forbid_cuda_in_plain(torch, ref)
    try:
        small = lm_small_reference(torch, np)
        print(f"[lm-train] 10a reduced {GRANITE} (C 4, m 4, S 16, 3 rounds): card == CPU assignments "
              f"{small['assign']}, cluster counts {small['counts']}; max |card - CPU| {small['errs']} "
              f"within rtol 1e-4, atol 1e-5 + 2 x float32's own error per leaf (max |CPU f32 - "
              f"CPU f64| {small['floors']}); segment kernel launches {small['launches']}", flush=True)
        lm = lm_train_phase(torch)
    finally:
        undo()
    s_round = statistics.median(lm["secs"])
    flop_ms = lm["flops"] / FP32_FLOPS * 1e3
    print(f"[lm-train] 10b {GRANITE} full width ({lm['n_params']:,} params, f32, {lm['n_layers']} "
          f"layers, attn_qchunk 512, ce_chunk 1024), {LM_C} clients x {LM_M} sequences x {LM_S} "
          f"tokens (synth_corpus groups {lm['groups']}), local_steps 2, d_sketch 128: init "
          f"{lm['init_s']:.2f} s; s/round {[round(x, 4) for x in lm['secs']]}; loss by round "
          f"{[round(x, 5) for x in lm['losses']]}; cluster counts {lm['counts']}", flush=True)
    print(f"[lm-train] 10b {lm['tokens'] / s_round:.1f} tokens/s (median round {s_round:.4f} s); "
          f"{lm['flops'] / 1e12:.2f} TFLOP a round (8 x N x {lm['tokens']} tokens: forward, backward, "
          f"recompute) bound {flop_ms / 1e3:.4f} s at 67 TFLOP/s f32 = {100 * flop_ms / 1e3 / s_round:.1f}% "
          f"of the FLOP bound; peak memory {lm['peak_gb']:.2f} GB (10c included: "
          f"{lm['peak_all_gb']:.2f} GB)", flush=True)
    sk_bytes_ms = LM_C * lm["n_last"] * 4 / HBM_BYTES_PER_S * 1e3
    print(f"[lm-train] 10b sketch per round {[round(x, 3) for x in lm['sk_ms']]} ms against its byte "
          f"bound {sk_bytes_ms:.4f} ms ({LM_C} x {lm['n_last']:,} last-block values read once) and "
          f"its bound {lm['sk_bound'][0]:.4f} ms ({lm['sk_bound'][1]}: their products with the "
          f"(block, 128) matrices; the {lm['n_last'] * 128 / 1e9:.2f}G Rademacher draws come on top)",
          flush=True)
    for sig, ms in sorted(lm["agg"].items(), key=lambda kv: -math.prod(kv[0][0])):
        (C, P, D), K, w = sig
        b = bound(C * P * D * 4 + C * P * (8 if w else 4) + C * K * D * 4, C * P * D * (2 if w else 1))
        print(f"[lm-train] 10b segment call {sig} x{len(ms)}: {statistics.median(ms):.4f} ms median "
              f"(events, in the step) against its bound {b[0]:.4f} ms ({b[1]})", flush=True)
    print(f"[lm-train] 10b segment kernel launches {lm['launches']} = {LM_ROUNDS} rounds x (2 "
          f"clustering + {lm['n_leaves']} leaves), none on the plain version", flush=True)
    print(f"[lm-train] 10c central steps (B 4 x {LM_S}, 4 clients) loss {lm['closs']}; prefill 2 x "
          f"{LM_S} in {lm['prefill_s']:.4f} s; 8 served tokens against a 1024-slot cache in "
          f"{lm['serve_s']:.4f} s, greedy {lm['served']}; all finite", flush=True)
    sizes = [a.numel() for a in leaves(build_model(get_config(GRANITE)).init_shapes())]
    sigs = lm_row_sigs(sizes, LM_C, 128, 2, torch.float32)
    worst = check_rows(torch, ops, ref, [], sigs, torch.int32)["segment_aggregate"]
    rows = {}
    for sig in sigs:
        t = time_segment(torch, ops, ref, sig, id_dtype=torch.int32, inner=3, reps=5)
        print_row("segment_aggregate", f"LM path {sig}", t)
        (C, P, D), K, _, weighted = sig
        rows[f"lm_{C}_{P}_{D}_k{K}{'_w' if weighted else ''}"] = row_json(sig, t)
    return dict(launches=lm["launches"], rows=rows, worst=worst, peak_gb=lm["peak_gb"])


def lm_only(torch) -> int:
    """``--lm-train``: build, then phase 10 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref

    so = build.build()
    print(f"[build] {so}")
    out = run_lm_phase(torch, np, ops, ref)
    print(json.dumps({"lm_rows": out["rows"], "lm_launches": out["launches"],
                      "max_abs_err": out["worst"]}))
    print(smi())
    return 0


# ---------------------------------------------------- phase 11: engine modes
# tests/test_pipeline.py's scenario (tests/torch_engine_cases.py MODES_*):
# 300 clients, 4 groups, 60 participants, 30 rounds, two partitions
MODES_POP = dict(n_clients=300, n_groups=4, group_sep=0.0, dirichlet=3.0,
                 label_conflict=1.0, seed=5)
MODES_FL = dict(rounds=30, participants_per_round=60, eval_every=29,
                use_availability=False, seed=5)
MODES_AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=3, clustering_start_frac=0.03,
                  partition_start_frac=0.08, partition_end_frac=0.9, min_members=6,
                  margin_threshold=0.35)
# the population plane at full width: benchmarks/population_scale.py's full
# engine (1M clients, the chunked store, the streaming procedural plane) plus
# its store sweep's churn (~100 departures a round at 1M); only rounds cut
POP_PLANE = dict(n_groups=4, group_sep=0.0, dirichlet=3.0, label_conflict=1.0, seed=7)
POP_FL = dict(participants_per_round=200, population_store=True, availability_mode="chunked",
              use_availability=True, eval_every=10**9, seed=7)
POP_AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=4, clustering_start_frac=0.0,
                partition_start_frac=0.3, partition_end_frac=0.9, min_members=10)
POP_ROUNDS = 6
POP_SIZES = (100_000, 1_000_000)
ROUND_KERNELS = ("cosine_similarity", "segment_aggregate")
WIDE_MLP = (1024, 4)  # 11b's wide MLP (hidden, depth): 3.2M params a client


def modes_engine(pop, fl=MODES_FL, auxo=MODES_AUXO, **kw):
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    return AuxoEngine(MLPTask(dim=pop.dim, n_classes=pop.n_classes), pop, FLConfig(**{**fl, **kw}),
                      AuxoConfig(**auxo), device="cuda")


def run_stale_sync(torch, eng, rounds: int):
    """tests/torch_engine_cases.py's oracle with ``torch.cuda.synchronize()``
    after every dispatch: the overlapped schedule's host order (round r
    planned before round r-1's feedback, flush on partition) on a
    synchronous pipeline, every result read eagerly."""
    p = eng.pipeline
    p.host_control = True
    staged = inflight = None
    for r in range(rounds):
        prev, inflight = inflight, None
        if staged is not None and staged[0] == r:
            _, plan, packed = staged
        else:
            _, plan, packed = p._plan_and_pack(r)
        staged = None
        res = p.execute(plan, packed) if plan is not None else None
        torch.cuda.synchronize()
        if res is not None:
            res.sketches, res.losses
        events = prev is not None and p.apply_feedback(*prev)
        if plan is not None:
            if events:
                p.apply_feedback(plan, res)
            else:
                inflight = (plan, res)
        staged = p._plan_and_pack(r + 1)
    if inflight is not None:
        p.apply_feedback(*inflight)
    return eng


class Launches:
    """Launch counts of the round kernels per path: ``with counts(path):``
    sets both wrappers' counts to 0 just before and adds them just after."""

    def __init__(self, cs, sa):
        self.mods = {"cosine_similarity": cs, "segment_aggregate": sa}
        self.by_path = {}

    def __call__(self, path):
        import contextlib

        @contextlib.contextmanager
        def window():
            for m in self.mods.values():
                m.launches = 0
            yield
            acc = self.by_path.setdefault(path, dict.fromkeys(self.mods, 0))
            for name, m in self.mods.items():
                acc[name] += m.launches

        return window()

    def check(self):
        for path, n in self.by_path.items():
            if min(n.values()) <= 0:
                raise AssertionError(f"engine modes: a round kernel never launched on {path}: {n}")


def bank_diff(torch, ea, eb):
    """Names of bank tensors (params, optimizer state) that differ."""
    _, fa = bank_digest(ea)
    _, fb = bank_digest(eb)
    return [k for k in fa if not torch.equal(fa[k], fb[k])]


def sync_calls(torch, fn):
    """fn() under PyTorch's sync debug mode "warn": returns (fn's result,
    [file:line of each call that synchronized with the card])."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in ws
                 if "synchroniz" in str(w.message)]


def initialized_clusterers(eng) -> int:
    return sum(bool(cl.state.initialized) for cl in eng.coordinator.clusterers.values())


def stepped(torch, rounds: int, overlap: int, hidden: int = 64, depth: int = 2,
            count_syncs: bool = False):
    """The main run's engine (openimage-like, ``MLPTask(hidden, depth)``)
    stepped ``rounds`` times, no evaluation: s/round of the steps alone, or
    with ``count_syncs`` (not timed: the debug mode costs time) the calls
    that synchronized with the card per round, each round marked as a flush
    (a partition drained the pipeline), a k-means bootstrap (a clusterer
    started) or steady."""
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    pop = make_population(**POP)
    eng = AuxoEngine(MLPTask(dim=pop.dim, n_classes=pop.n_classes, hidden=hidden, depth=depth), pop,
                     FLConfig(rounds=ROUNDS, participants_per_round=100, use_availability=True,
                              seed=1, round_overlap=overlap), AuxoConfig(**AUXO), device="cuda")
    syncs, kinds = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(rounds):
        if count_syncs:
            n_init, n_flush = initialized_clusterers(eng), eng.pipeline.flushes
            _, calls = sync_calls(torch, lambda: eng.step(r))
            syncs.append(calls)
            kinds.append("flush" if eng.pipeline.flushes > n_flush else "bootstrap"
                         if initialized_clusterers(eng) > n_init else "steady")
        else:
            eng.step(r)
    eng.pipeline.flush()
    torch.cuda.synchronize()
    return dict(s_round=(time.perf_counter() - t0) / rounds, syncs=syncs, kinds=kinds,
                stage={k: round(v, 4) for k, v in eng.pipeline.stage_seconds.items()},
                parts=[(e.parent, e.round_idx) for e in eng.coordinator.partitions])


def population_run(torch, n: int, overlap: int, counts):
    """The full-width population plane: ``POP_ROUNDS`` steps at n clients
    with churn; host ms per step call (no synchronisation added: under the
    overlap a step returns with its round in flight)."""
    from repro_torch.data import ProceduralDataPlane
    from repro_torch.scale import ChurnStream

    class Counted(ChurnStream):
        departed = 0

        def step(self, r):
            dep, arr = super().step(r)
            self.departed += dep.size
            return dep, arr

    plane = ProceduralDataPlane(n_clients=n, **POP_PLANE)
    eng = modes_engine(plane, dict(POP_FL, rounds=POP_ROUNDS), POP_AUXO, round_overlap=overlap)
    eng.churn = Counted(n, depart_rate=1e-4, return_rate=0.1, seed=7)
    times = []
    with counts(f"population {n:,} overlap {overlap}"):
        torch.cuda.synchronize()
        for r in range(POP_ROUNDS):
            t0 = time.perf_counter()
            eng.step(r)
            times.append((time.perf_counter() - t0) * 1e3)
        eng.pipeline.flush()
        torch.cuda.synchronize()
    p = eng.pipeline
    if p.exec_dispatches < POP_ROUNDS:
        raise AssertionError(f"population {n}: {p.exec_dispatches} dispatches in {POP_ROUNDS} rounds")
    if not all(bool(torch.isfinite(v).all()) for v in p.bank.params.values()):
        raise AssertionError(f"population {n}: non-finite bank params")
    return dict(ms=statistics.median(times[1:]), times=times, plane=plane.data_nbytes,
                store=eng.store.nbytes, rows=eng.store.n_rows, departed=eng.churn.departed,
                away=int(eng.store.n_departed), dispatches=p.exec_dispatches,
                parts=[(e.parent, e.round_idx) for e in eng.coordinator.partitions],
                stage={k: round(v, 4) for k, v in p.stage_seconds.items()})


def engine_modes_phase(torch, ops, ref, cs, sa, sync_secs: float) -> dict:
    """Phase 11: the sequential oracle (11a), the depth-2 overlap (11b) and
    the population plane (11c) on the card. Plain versions raise on CUDA
    tensors throughout; every path's round-kernel launches are counted."""
    from repro_torch.data import make_population

    counts = Launches(cs, sa)
    shapes = {"cosine_similarity": {}, "segment_aggregate": {}}
    undo = [
        record(cs, "cosine_similarity",
               lambda x, c, eps=1e-8: (tuple(x.shape), tuple(c.shape), x.dtype),
               shapes["cosine_similarity"]),
        record(sa, "segment_aggregate",
               lambda d, i, k, w=None: (tuple(d.shape), int(k), d.dtype, w is not None),
               shapes["segment_aggregate"]),
        forbid_cuda_in_plain(torch, ref),
    ]
    rounds = MODES_FL["rounds"]
    try:
        # ------------------------------------------- 11a: sequential oracle
        pop = make_population(**MODES_POP)
        eb, es = modes_engine(pop), modes_engine(pop, execution="sequential")
        gaps = []
        for r in range(rounds):
            # the oracle starts every round from the batched bank: free runs
            # drift apart past the tolerance once an ulp-level difference
            # meets FedYoGi's sign(v - d^2) (tests/test_torch_sequential.py)
            es.pipeline.bank.params, es.pipeline.bank.opt_state = (
                eb.pipeline.bank.params, eb.pipeline.bank.opt_state)
            with counts("11a batched"):
                eb.step(r)
            with counts("11a sequential"):
                es.step(r)
            gap = 0.0
            for k, v in eb.pipeline.bank.params.items():
                w = es.pipeline.bank.params[k]
                if not torch.allclose(w, v, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"11a round {r}: {k} differs batched vs sequential")
                gap = max(gap, (w - v).abs().max().item())
            gaps.append(gap)
        pb = [(e.parent, e.round_idx) for e in eb.coordinator.partitions]
        if len(pb) != 2 or pb != [(e.parent, e.round_idx) for e in es.coordinator.partitions]:
            raise AssertionError(f"11a partitions: batched {pb}, sequential "
                                 f"{[(e.parent, e.round_idx) for e in es.coordinator.partitions]}")
        if eb.coordinator.tree.leaves() != es.coordinator.tree.leaves():
            raise AssertionError("11a: leaves differ")
        if eb.pipeline.exec_dispatches != rounds or es.pipeline.exec_dispatches <= rounds:
            raise AssertionError(f"11a dispatches {eb.pipeline.exec_dispatches}, "
                                 f"{es.pipeline.exec_dispatches}")
        print(f"[modes] 11a sequential oracle, {MODES_POP['n_clients']} clients x {rounds} rounds: "
              f"partitions {pb} in both; from the same bank each round, max |batched - sequential| "
              f"{max(gaps):.3e} (rtol 1e-4, atol 1e-4); dispatches batched "
              f"{eb.pipeline.exec_dispatches}, sequential {es.pipeline.exec_dispatches}", flush=True)
        del eb, es

        # ------------------------------------------- 11b: depth-2 overlap
        ea = modes_engine(pop, round_overlap=1)
        with counts("11b overlap"):
            for r in range(rounds):
                ea.step(r)
            ea.pipeline.flush()
        with counts("11b stale-sync oracle"):
            eo = run_stale_sync(torch, modes_engine(pop), rounds)
        pa = [(e.parent, e.round_idx) for e in ea.coordinator.partitions]
        if not pa or pa != [(e.parent, e.round_idx) for e in eo.coordinator.partitions]:
            raise AssertionError(f"11b partitions differ: {pa}")
        diff = bank_diff(torch, ea, eo)
        if diff:
            raise AssertionError(f"11b: overlap vs stale-sync bank differs at {diff}")
        if not ((ea.pipeline.table.reward == eo.pipeline.table.reward).all()
                and (ea.fingerprint == eo.fingerprint).all()):
            raise AssertionError("11b: table.reward or the fingerprints differ")
        if ea.pipeline.flushes < 1 or ea.pipeline.exec_dispatches != rounds:
            raise AssertionError(f"11b flushes {ea.pipeline.flushes}, dispatches "
                                 f"{ea.pipeline.exec_dispatches}")
        print(f"[modes] 11b overlap vs the stale-sync oracle (a synchronize after every dispatch): "
              f"bank, table.reward and fingerprints bit-equal; partitions {pa}; flushes "
              f"{ea.pipeline.flushes}; dispatches {ea.pipeline.exec_dispatches}", flush=True)
        del ea, eo
        with counts("11b main run overlap"):
            eng, hist, secs = run_main(torch, ROUNDS, round_overlap=1)
        if len(eng.coordinator.tree.leaves()) < 2 or not all(0.0 <= h["acc_mean"] <= 1.0 for h in hist):
            raise AssertionError("11b main run: fewer than 2 leaves or a bad accuracy")
        print(f"[modes] 11b run_auxo openimage-like, {ROUNDS} rounds, round_overlap=1: {secs:.3f} s "
              f"({secs / ROUNDS:.4f} s/round; phase 4 synchronous {sync_secs / ROUNDS:.4f} s/round, "
              f"evaluation every {max(2, ROUNDS // 20)} rounds included, each one a drain); host stage "
              f"seconds {eng.pipeline.stage_seconds}; flushes {eng.pipeline.flushes}; partitions "
              f"{[(e.parent, e.round_idx) for e in eng.coordinator.partitions]}; acc_mean "
              f"{[round(h['acc_mean'], 4) for h in hist][-3:]}", flush=True)
        del eng
        # the detector sees a known synchronizing call (else a count of 0 says nothing)
        _, canary = sync_calls(torch, lambda: torch.ones(1, device="cuda").item())
        if len(canary) != 1:
            raise AssertionError(f"sync debug mode reported {canary} for one .item()")
        # the steps alone, synchronous then overlapped: the main run's MLP
        # (the card busy ~5% of a round) and a wide one (hidden 1024, depth
        # 4: some 0.4 TFLOP a round, device time near the host's)
        for hidden, depth in ((64, 2), WIDE_MLP):
            with counts(f"11b steps hidden {hidden}"):
                st = [stepped(torch, ROUNDS, overlap, hidden, depth) for overlap in (0, 1)]
            print(f"[modes] 11b steps only (no evaluation), MLP hidden {hidden} depth {depth}, "
                  f"{ROUNDS} rounds: synchronous {st[0]['s_round']:.4f} s/round (stages "
                  f"{st[0]['stage']}), overlapped {st[1]['s_round']:.4f} s/round (stages "
                  f"{st[1]['stage']}) = {st[1]['s_round'] / st[0]['s_round']:.3f}x; partitions "
                  f"{st[0]['parts']} / {st[1]['parts']}", flush=True)
        with counts("11b sync count"):
            ov = stepped(torch, ROUNDS, 1, count_syncs=True)
        steady = [len(c) for c, k in zip(ov["syncs"], ov["kinds"]) if k == "steady"]
        where = sorted({w for c, k in zip(ov["syncs"], ov["kinds"]) if k == "steady" for w in c})
        other = {k: [len(c) for c, kk in zip(ov["syncs"], ov["kinds"]) if kk == k]
                 for k in ("flush", "bootstrap")}
        print(f"[modes] 11b synchronizing calls per overlapped round (sync debug mode warn; one "
              f".item() reads as 1): steady rounds {len(steady)}, calls {steady} (max "
              f"{max(steady, default=0)}) at {where}; flush rounds {other['flush']}, bootstrap "
              f"rounds {other['bootstrap']}", flush=True)

        # ------------------------------------------ 11c: population plane
        pops = {}
        for n in POP_SIZES:
            for overlap in (0, 1):
                pops[(n, overlap)] = row = population_run(torch, n, overlap, counts)
                print(f"[modes] 11c N={n:,} overlap {overlap}: {row['ms']:.2f} ms/round (median of "
                      f"rounds 1-{POP_ROUNDS - 1}; all {[round(t, 2) for t in row['times']]}); plane "
                      f"{row['plane']:,} B, store {row['store']:,} B, touched rows {row['rows']:,}, "
                      f"departures {row['departed']} ({row['away']} away at the end), dispatches "
                      f"{row['dispatches']}, partitions {row['parts']}, launches "
                      f"{counts.by_path[f'population {n:,} overlap {overlap}']}, stage seconds "
                      f"{row['stage']}", flush=True)
        for overlap in (0, 1):
            ratio = pops[(POP_SIZES[1], overlap)]["plane"] / pops[(POP_SIZES[0], overlap)]["plane"]
            if ratio > 1.5:
                raise AssertionError(f"11c: plane bytes scale with N (x{ratio:.2f}, overlap {overlap})")
        # tests/test_population_scale.py's store-versus-dense scenario
        for overlap in (0, 1):
            with counts(f"11c store vs dense overlap {overlap}"):
                dense = modes_engine(pop, round_overlap=overlap)
                store = modes_engine(pop, round_overlap=overlap, population_store=True)
                for e in (dense, store):
                    for r in range(rounds):
                        e.step(r)
                    e.pipeline.flush()
            diff = bank_diff(torch, dense, store)
            rw, _, _ = store.pipeline.table.to_dense(MODES_POP["n_clients"])
            if diff or not (rw == dense.pipeline.table.reward).all():
                raise AssertionError(f"11c store vs dense (overlap {overlap}) differs at {diff}")
        print(f"[modes] 11c store vs dense ({MODES_POP['n_clients']} clients, {rounds} rounds), sync "
              f"and overlap: banks and reward tables bit-equal", flush=True)
    finally:
        for u in undo:
            u()
    counts.check()
    worst = check_rows(torch, ops, ref, list(shapes["cosine_similarity"]),
                       list(shapes["segment_aggregate"]))
    print(f"[modes] launches by path {counts.by_path}", flush=True)
    print(f"[modes] {len(shapes['cosine_similarity'])} cosine and {len(shapes['segment_aggregate'])} "
          f"segment call shapes of phase 11 held against the plain version: max |err| {worst}",
          flush=True)
    total = {k: sum(n[k] for n in counts.by_path.values()) for k in ROUND_KERNELS}
    return dict(launches=total, by_path=counts.by_path, worst=worst, steady_syncs=steady,
                sync_sites=where)


def engine_modes_only(torch) -> int:
    """``--engine-modes``: build, phase 4's synchronous main run (the s/round
    that 11b is printed beside), then phase 11 alone."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa

    print(smi())
    so = build.build()
    print(f"[build] {so}")
    run_main(torch, 2)  # warm-up: the first run also pays the card's and the libraries' start
    _, _, secs = run_main(torch, ROUNDS)
    print(f"[main] run_auxo openimage-like, {ROUNDS} rounds, synchronous: {secs / ROUNDS:.4f} s/round")
    out = engine_modes_phase(torch, ops, ref, cs, sa, secs)
    print(json.dumps({"engine_modes_launches": out["by_path"], "max_abs_err": out["worst"],
                      "steady_syncs": out["steady_syncs"], "sync_sites": out["sync_sites"]}))
    print(smi())
    return 0

# ------------------------------------------- phase 12: evaluation and baselines
# Table 5 (benchmarks/table5_clustered_fl.py) at its own settings runs in
# phase 21 through repro_torch.paper: femnist-like, 80 rounds, k 4
T5_ROUNDS = 80
T5_K = 4
FTFA_STEPS = 5
FEEDBACK_ROWS = 100  # 12b's feedback call: the first fingerprinted clients


def ftfa_captured(torch, eng):
    """``eng.ftfa_eval(FTFA_STEPS)`` with the personalised params (rows plus
    their fine-tuning deltas, on the host) captured: (value, params, s)."""
    from repro_torch.fl import engine as fe
    from repro_torch.utils.tree import tree_map

    seen = {}
    orig = fe.local_train

    def rec(loss, p, *a, **k):
        out = orig(loss, p, *a, **k)
        seen["params"] = tree_map(lambda u, v: (u + v).cpu(), p, out[0])
        return out

    fe.local_train = rec
    try:
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = eng.ftfa_eval(steps=FTFA_STEPS)
        secs = time.perf_counter() - t0
    finally:
        fe.local_train = orig
    return value, seen["params"], secs


def eval_baselines_phase(torch, np, ops, ref, cs, sa, eng, small) -> dict:
    """Phase 12 on phase 4's engine ``eng`` and phase 4a's engines
    ``small`` (card and CPU): FTFA (12a), coordinator failover (12b), then
    every kernel call shape of the phase held against the plain version
    (12d; Table 5, once 12c, runs in phase 21). Plain versions raise on
    CUDA tensors throughout; each path's launches are counted from 0."""
    from repro_torch.core.coordinator import CohortCoordinator

    counts = Launches(cs, sa)
    shapes = {"cosine_similarity": {}, "segment_aggregate": {}}
    undo = [
        record(cs, "cosine_similarity",
               lambda x, c, eps=1e-8: (tuple(x.shape), tuple(c.shape), x.dtype),
               shapes["cosine_similarity"]),
        record(sa, "segment_aggregate",
               lambda d, i, k, w=None: (tuple(d.shape), int(k), d.dtype, w is not None),
               shapes["segment_aggregate"]),
        forbid_cuda_in_plain(torch, ref),
    ]
    out = {}
    try:
        # ------------------------------------------------------- 12a: FTFA
        n_rows = len(range(0, eng.data.n_clients, max(1, eng.data.n_clients // 100)))
        with counts("12a ftfa"):
            value, pf, secs = ftfa_captured(torch, eng)
        if not (0.0 <= value <= 1.0) or any(v.shape[0] != n_rows for v in pf.values()):
            raise AssertionError(f"12a: ftfa value {value}, rows {[v.shape for v in pf.values()]}")
        if not all(bool(torch.isfinite(v).all()) for v in pf.values()):
            raise AssertionError("12a: non-finite personalised params")
        vals = {dev: ftfa_captured(torch, small[dev]) for dev in ("cuda", "cpu")}
        (vg, pg, sg), (vc, pc, sc) = vals["cuda"], vals["cpu"]
        gap = max((pg[k] - pc[k]).abs().max().item() for k in pg)
        if not all(torch.allclose(pg[k], pc[k], rtol=1e-4, atol=1e-5) for k in pg):
            raise AssertionError(f"12a: personalised params differ card vs CPU (max {gap})")
        if not math.isclose(vg, vc, rel_tol=1e-4, abs_tol=1e-5):
            raise AssertionError(f"12a: ftfa value card {vg} vs CPU {vc}")
        if small["cuda"].rng.bit_generator.state != small["cpu"].rng.bit_generator.state:
            raise AssertionError("12a: the training rng advanced differently on the card")
        print(f"[eval] 12a ftfa_eval(steps={FTFA_STEPS}) on phase 4's engine (openimage-like, "
              f"{eng.data.n_clients} clients -> {n_rows} rows, one row-stacked local_train): "
              f"{value:.6f} in {secs:.4f} s; the 120-client run: card {vg:.6f} ({sg:.4f} s), CPU "
              f"{vc:.6f} ({sc:.4f} s), personalised params max |card - CPU| {gap:.3e} (rtol 1e-4, "
              f"atol 1e-5), training rng states equal", flush=True)
        out["ftfa"] = dict(value=value, s=secs, rows=n_rows, small=(vg, vc), gap=gap)

        # --------------------------------------------------- 12b: failover
        co = eng.coordinator
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        path = os.path.join(ROOT, "build", "coordinator.ckpt")
        co.checkpoint(path)
        co2 = CohortCoordinator.recover(path, device="cuda")
        if set(co2.tree.leaves()) != set(co.tree.leaves()) or co2.blacklist != co.blacklist:
            raise AssertionError(f"12b: recovered leaves {co2.tree.leaves()} vs {co.tree.leaves()}")
        reqs = []
        for c in range(200):
            pref = eng.preferred_cohort(c)
            if pref:
                reqs.append((c, pref, max(0, eng.client_cluster_index(c, pref))))
        co3 = CohortCoordinator(d_sketch=AUXO["d_sketch"], device="cuda")
        co3.rebuild_from_requests(reqs)
        if not reqs or not {r[1] for r in reqs} <= set(co3.tree.nodes):
            raise AssertionError(f"12b: rebuild from {len(reqs)} requests gave {co3.tree.leaves()}")
        # one cohort's feedback on the card and on the CPU, from the same
        # checkpoint: the k-means bootstrap, then a steady-state step
        leaf = co.tree.leaves()[0]
        ids = np.flatnonzero(eng.fp_seen)[:FEEDBACK_ROWS]
        sk = np.ascontiguousarray(eng.fingerprint[ids], np.float32)
        cos = {dev: CohortCoordinator.recover(path, device=dev) for dev in ("cuda", "cpu")}
        fb_gap = 0.0
        for step, r in enumerate((ROUNDS // 2, ROUNDS // 2 + 1)):
            msgs = {}
            for dev, c in cos.items():
                with counts(f"12b feedback {dev}") if dev == "cuda" else contextlib.nullcontext():
                    msgs[dev], _ = c.feedback(leaf, ids.tolist(), torch.from_numpy(sk).to(dev), r, ROUNDS)
            ag = [m.cluster_index for m in msgs["cuda"].values()]
            ac = [m.cluster_index for m in msgs["cpu"].values()]
            if ag != ac or min(ag) < 0:
                raise AssertionError(f"12b feedback {step}: assignments differ card vs CPU")
            for i, m in msgs["cpu"].items():
                d = abs(msgs["cuda"][i].reward - m.reward)
                if d > 1e-5 * max(1.0, abs(m.reward)):
                    raise AssertionError(f"12b feedback {step}: client {i}'s reward card vs CPU differs by {d}")
                fb_gap = max(fb_gap, d)
        print(f"[eval] 12b failover on phase 4's engine: checkpoint -> recover on the card restored "
              f"the leaves {co2.tree.leaves()} and blacklist ({len(co2.blacklist)}); "
              f"rebuild_from_requests from {len(reqs)} of 200 clients' requests -> "
              f"{co3.tree.leaves()}; feedback({leaf!r}, {ids.size} fingerprints) twice on recovered "
              f"coordinators, card == CPU assignments, rewards max |diff| {fb_gap:.3e}", flush=True)
        out["failover"] = dict(leaves=co2.tree.leaves(), requests=len(reqs), rebuilt=co3.tree.leaves(),
                               reward_gap=fb_gap)

    finally:
        for u in undo:
            u()
    if min(counts.by_path["12b feedback cuda"].values()) <= 0:
        raise AssertionError(f"12b: a round kernel never launched: {counts.by_path['12b feedback cuda']}")
    # FTFA's routing is numpy
    if max(counts.by_path["12a ftfa"].values()) != 0:
        raise AssertionError(f"12a ftfa launched a round kernel: {counts.by_path['12a ftfa']}")
    # ------------------------------------------------ 12d: call shapes
    worst = check_rows(torch, ops, ref, list(shapes["cosine_similarity"]), list(shapes["segment_aggregate"]))
    print(f"[eval] launches by path {counts.by_path}", flush=True)
    print(f"[eval] {len(shapes['cosine_similarity'])} cosine and {len(shapes['segment_aggregate'])} "
          f"segment call shapes of phase 12 held against the plain version: max |err| {worst}",
          flush=True)
    out["launches"] = {k: sum(n[k] for n in counts.by_path.values()) for k in ROUND_KERNELS}
    out["by_path"] = counts.by_path
    out["worst"] = worst
    return out


def eval_baselines_only(torch) -> int:
    """``--eval-baselines``: build, phase 4a's small run (card and CPU),
    phase 4's main run, then phase 12 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa

    print(smi())
    so = build.build()
    print(f"[build] {so}")
    _, _, small = small_reference(torch)
    eng, _, secs = run_main(torch, ROUNDS)
    print(f"[main] run_auxo openimage-like, {ROUNDS} rounds: {secs / ROUNDS:.4f} s/round")
    out = eval_baselines_phase(torch, np, ops, ref, cs, sa, eng, small)
    print(json.dumps({"eval_baselines_launches": out["by_path"], "max_abs_err": out["worst"],
                      "ftfa": out["ftfa"]}))
    print(smi())
    return 0


# ------------------------------------------------- phase 13: model families
QWEN3_MOE = "qwen3-moe-235b-a22b"
MOE_ARCHS = (QWEN3_MOE, "llama4-maverick-400b-a17b")
FAM_STEPS = 3  # central steps at full width
FAM_B, FAM_S = 4, 512  # 4 clients x 512 tokens
MOE_GROUP = 256  # the config's routing group; cap 24 at top-8 of 128 experts
# tests/test_torch_moe.py's margins: rtol 1e-4, atol 1e-5 plus F32_FLOOR
# per tree (twice float32's own error, tests/test_torch_lm_train.py), and
# for llama4's third federated round twice its own (FedYoGi-amplified) error
F32_FLOOR = {"params": 1e-4, "opt": 0.0, "clust": 2e-3}
LLAMA4_ROUND3 = {"params": 9e-3, "opt": 3.5e-4, "clust": 0.07}


def fam_small_run(torch, np, arch, dev, seg_log):
    """13a, one run of a reduced MoE config on ``dev``: 3 rounds of
    make_train_step (4 clients x 4 x 16 tokens), then 2 steps of
    make_central_train_step (8 x 16 tokens, 4 clients) from the same init.
    Every segment call's (K, D, ids) goes into ``seg_log``."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    cfg = reduce_config(get_config(arch)).replace(attn_qchunk=8, ce_chunk=8, moe_group=8)
    model = build_model(cfg)
    init = model.init(rnd.key(0), device="cpu")
    rng = np.random.default_rng(0)
    toks_a = [rng.integers(0, cfg.vocab, (4, 4, 16)).astype(np.int32) for _ in range(3)]
    toks_b = [rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32) for _ in range(2)]
    undo = record(steps.kops, "segment_aggregate", lambda d, i, k, w=None: (int(k), d.shape[-1], i.cpu()),
                  seg_log)
    out = {}
    try:
        for mode, toks, make in (
                ("A", toks_a, lambda: steps.make_train_step(model, steps.StepConfig(
                    local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32))),
                ("B", toks_b, lambda: steps.make_central_train_step(
                    model, steps.StepConfig(server_lr=0.2, d_sketch=32), n_clients=4))):
            params = tree_map(lambda a: a.to(dev, copy=True), init)
            opt, clust = steps.yogi_init(params), steps.clustering_init(2, 32, device=dev)
            step, losses, counts = make(), [], []
            for t in toks:
                params, opt, clust, met = step(params, opt, clust, {"tokens": torch.from_numpy(t).to(dev)})
                losses.append(float(met["loss"]))
                counts.append(met["cluster_counts"].tolist())
            out[mode] = dict(state=(params, opt, clust), losses=losses, counts=counts)
    finally:
        undo()
    return out


def fam_small_reference(torch, np):
    """13a: reduced qwen3-moe and llama4 on the CPU and twice on the card.
    Card vs CPU: equal assignments and counts, states within the tests'
    margins; the two card runs bit-identical (loss bits and a float64
    checksum of every leaf)."""
    from repro_torch.utils.tree import leaves, leaves_with_path

    report = {}
    for arch in MOE_ARCHS:
        logs = {run: [] for run in ("cpu", "cuda", "cuda2")}
        runs = {run: fam_small_run(torch, np, arch, run.rstrip("2"), logs[run]) for run in logs}
        cpu, card = runs["cpu"], runs["cuda"]
        if ([(k, d) for k, d, _ in logs["cuda"]] != [(k, d) for k, d, _ in logs["cpu"]]
                or not all(torch.equal(a[2], b[2]) for a, b in zip(logs["cuda"], logs["cpu"]))
                or any(card[m]["counts"] != cpu[m]["counts"] for m in "AB")):
            raise AssertionError(f"13a {arch}: assignments or counts differ card vs CPU: "
                                 f"{[card[m]['counts'] for m in 'AB']} vs {[cpu[m]['counts'] for m in 'AB']}")
        errs = {}
        for m in "AB":
            floor = LLAMA4_ROUND3 if (m == "A" and arch.startswith("llama4")) else F32_FLOOR
            for name, got, want in zip(("params", "opt", "clust"), card[m]["state"], cpu[m]["state"]):
                want = dict(leaves_with_path(want))
                for k, v in leaves_with_path(got):
                    err = (v.cpu() - want[k]).abs().max().item()
                    errs[f"{m} {name}"] = max(errs.get(f"{m} {name}", 0.0), err)
                    if not torch.allclose(v.cpu(), want[k], rtol=1e-4, atol=1e-5 + floor[name]):
                        raise AssertionError(f"13a {arch} mode {m}: {name} {k} differs card vs CPU by {err}")

        def digest(run):
            return ([float.hex(x) for m in "AB" for x in run[m]["losses"]],
                    [float(a.double().sum()) for m in "AB" for t in run[m]["state"] for a in leaves(t)])

        if digest(card) != digest(runs["cuda2"]):
            raise AssertionError(f"13a {arch}: two card runs from the same state differ")
        ag = [i[0].tolist() for k, d, i in logs["cuda"] if k > 1 and d > 1]
        report[arch] = dict(errs=errs, assign=ag, counts=[card[m]["counts"] for m in "AB"],
                            losses=[card[m]["losses"] for m in "AB"], n_leaves=len(leaves(card["A"]["state"][0])))
        del runs
    return report


def moe_stage_ms(torch, moe, cfg, p_moe, x, reps: int = 5):
    """Device ms (CUDA events, median of ``reps`` after one warm-up) of the
    four MoE stages on x (B, S, D); the chained stages must equal moe_apply."""
    from repro_torch.utils.tree import tree_map

    P = tree_map(lambda a: a[None], p_moe)
    names = ("router", "dispatch", "experts", "combine")
    samples = {n: [] for n in names}
    with torch.no_grad():
        for r in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            xg = moe.group(cfg, x[None])
            w, ids, _ = moe.route(P, cfg, xg)
            ev[1].record()
            ein, comb, keep = moe.dispatch(cfg, xg, w, ids)
            ev[2].record()
            eo = moe.experts(P, ein)
            ev[3].record()
            y = moe.combine(comb, eo)
            ev[4].record()
            torch.cuda.synchronize()
            if r:
                for i, n in enumerate(names):
                    samples[n].append(ev[i].elapsed_time(ev[i + 1]))
        want, aux = moe.moe_apply(p_moe, cfg, x)
    if not torch.equal(y.reshape(x.shape), want):
        raise AssertionError("13b: the chained MoE stages differ from moe_apply")
    return {n: statistics.median(v) for n, v in samples.items()}, ein.shape, float(aux["frac_dropped"])


def fam_qwen3_phase(torch):
    """13b: qwen3-moe-235b-a22b at full width, depth 1 (float32): the
    central step x3 on 4 x 512 tokens, the MoE stages of one forward, a
    prefill of 2 x 512 and 8 served tokens."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model, common, moe, transformer
    from repro_torch.utils.tree import leaves, tree_map

    model = build_model(get_config(QWEN3_MOE).replace(n_layers=1))
    cfg = model.cfg
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.vocab,
            cfg.moe_group) != (4096, 64, 4, 128, 8, 1536, 151936, MOE_GROUP):
        raise AssertionError(f"13b: {QWEN3_MOE} is not at its published width: {cfg}")
    n_params = model.param_count()
    n_experts = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(rnd.key(0), device="cuda")
    opt = steps.yogi_init(params)
    clust = steps.clustering_init(2, 128, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = steps.make_central_train_step(model, steps.StepConfig(d_sketch=128), n_clients=FAM_B)
    toks = torch.from_numpy(synth_corpus(FAM_B, 1, FAM_S, cfg.vocab)[0].reshape(FAM_B, FAM_S)).cuda()
    aux_log = []
    orig = moe.moe_apply

    def logged(p, c, x):  # the step's forward and its checkpointed recompute
        y, aux = orig(p, c, x)
        aux_log.append({k: v.detach() for k, v in aux.items()})
        return y, aux

    moe.moe_apply = logged
    secs, losses, counts = [], [], []
    try:
        for _ in range(FAM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, clust, met = step(params, opt, clust, {"tokens": toks})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            counts.append(met["cluster_counts"].tolist())
    finally:
        moe.moe_apply = orig
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses) or not all(bool(torch.isfinite(a).all()) for a in leaves(params)):
        raise AssertionError(f"13b: non-finite loss {losses} or params")
    if any(sum(c) != FAM_B for c in counts):
        raise AssertionError(f"13b: cluster counts {counts} do not sum to {FAM_B}")
    aux = [{k: float(v) for k, v in a.items()} for a in aux_log[::2]]  # each step's forward
    if len(aux_log) != 2 * FAM_STEPS or not all(math.isfinite(v) for a in aux for v in a.values()):
        raise AssertionError(f"13b: MoE aux {aux}")
    T = FAM_B * FAM_S
    G, cap = T // MOE_GROUP, moe._capacity(MOE_GROUP, cfg)
    flops = 8 * ((n_params - n_experts) * T + 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cap * G)

    # the MoE stages of one forward, on the input the layer's MoE sees
    lay = tree_map(lambda a: a[0], params["backbone"]["blocks"])
    with torch.no_grad():
        h = transformer.embed_tokens(params, cfg, toks)
        pos = common.default_positions(cfg, FAM_B, FAM_S, device=h.device)
        h = h + common.attention(lay["attn"], cfg, common.rmsnorm(lay["attn_norm"], h, cfg.norm_eps), pos)
        xm = common.rmsnorm(lay["moe_norm"], h, cfg.norm_eps)
    stage_ms, ein_shape, frac = moe_stage_ms(torch, moe, cfg, lay["moe"], xm)
    del h, xm
    expert_flops = 3 * 2 * cfg.n_experts * G * cap * cfg.d_model * cfg.d_ff

    # serving: a prefill of 2 x 512, then 8 tokens against a fresh cache
    prompt = toks[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = steps.make_prefill_step(model, steps.StepConfig())(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if tuple(last.shape) != (2, 1, cfg.vocab) or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"13b: prefill logits {tuple(last.shape)} not finite")
    served, serve_s = serve_tokens(torch, model, params, prompt[:, :1], steps)
    peak_all = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, step, last
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, n_experts=n_experts, init_s=init_s, secs=secs, losses=losses,
                counts=counts, aux=aux, peak_gb=peak_gb, peak_all_gb=peak_all, tokens=T, flops=flops,
                G=G, cap=cap, stage_ms=stage_ms, ein_shape=tuple(ein_shape), stage_frac=frac,
                expert_flops=expert_flops, prefill_s=prefill_s, serve_s=serve_s, served=served)


def serve_tokens(torch, model, params, cur, steps, n: int = 8):
    """n greedy tokens through make_serve_step against a fresh 1024-slot
    cache, from ``cur``; all logits finite and of the reference's shape."""
    cfg = model.cfg
    serve = steps.make_serve_step(model, steps.StepConfig())
    B = cur.shape[0]
    cache = model.init_cache(B, 1024, device="cuda")
    want = (B, 1, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks else (B, 1, cfg.padded_vocab)
    served = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        logits, cache = serve(params, cache, {"tokens": cur})
        if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.arch_id}: serve logits {tuple(logits.shape)} (want {want}) not finite")
        cur = torch.argmax(logits, dim=-1)
        if cfg.n_codebooks:
            cur = cur.transpose(1, 2)  # (B, 1, nc) -> (B, nc, 1)
        served.append(cur.reshape(B, -1)[:, 0].tolist())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if any(c["index"].tolist() != [n] * c["index"].shape[0] for c in cache.values() if "index" in c):
        raise AssertionError(f"{cfg.arch_id}: cache index after {n} tokens")
    return served, serve_s


def fam_full_depth(torch, arch):
    """13c: one central step, a prefill and 8 served tokens at full width
    and depth (float32): qwen2-vl-2b with 1024 random image patch
    embeddings before 512 text tokens, musicgen-large with 4 codebook
    streams of 512 tokens; 2 sequences, 2 clients."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves

    model = build_model(get_config(arch))
    cfg = model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(rnd.key(0), device="cuda")
    opt = steps.yogi_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if cfg.n_codebooks:
        toks = torch.from_numpy(synth_corpus(2, cfg.n_codebooks, FAM_S, cfg.vocab)[0]).cuda()
        batch = {"tokens": toks}
    else:
        toks = torch.from_numpy(synth_corpus(2, 1, FAM_S, cfg.vocab)[0].reshape(2, FAM_S)).cuda()
        g = torch.Generator(device="cuda").manual_seed(0)
        img = torch.randn((2, cfg.vision_patches, cfg.d_model), generator=g, device="cuda")
        batch = {"tokens": toks, "image_embeds": img}
    step = steps.make_central_train_step(model, steps.StepConfig(d_sketch=128), n_clients=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, _, met = step(params, opt, steps.clustering_init(2, 128, device="cuda"), batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    loss = float(met["loss"])
    if not math.isfinite(loss) or not all(bool(torch.isfinite(a).all()) for a in leaves(params)):
        raise AssertionError(f"13c {arch}: central step not finite (loss {loss})")
    if sum(met["cluster_counts"].tolist()) != 2:
        raise AssertionError(f"13c {arch}: cluster counts {met['cluster_counts'].tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = steps.make_prefill_step(model, steps.StepConfig())(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    want = (2, 1, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks else (2, 1, cfg.padded_vocab)
    if tuple(last.shape) != want or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"13c {arch}: prefill logits {tuple(last.shape)} (want {want}) not finite")
    cur = toks[:, :, :1] if cfg.n_codebooks else toks[:, :1]
    served, serve_s = serve_tokens(torch, model, params, cur, steps)
    out = dict(n_params=model.param_count(), n_layers=cfg.n_layers, init_s=init_s, step_s=step_s,
               loss=loss, prefill_s=prefill_s, serve_s=serve_s, served=served,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, seq=FAM_S + (0 if cfg.n_codebooks
                                                                            else cfg.vision_patches))
    del params, opt, step, last, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def families_phase(torch, np, ops, ref, sa, card) -> dict:
    """Phase 13 (after phase 12 has freed its memory): 13a reduced MoE card
    vs CPU, 13b qwen3-moe at full width, 13c qwen2-vl-2b and musicgen-large
    at full width and depth, 13d every segment call shape of the phase
    held against the plain version. The plain versions raise on CUDA
    tensors throughout; the segment launches of 13a-13c are counted from 0."""
    from repro_torch.launch import steps

    gc.collect()
    torch.cuda.empty_cache()
    shapes = {}
    undo = [forbid_cuda_in_plain(torch, ref),
            record(steps.kops, "segment_aggregate",
                   lambda d, i, k, w=None: (tuple(d.shape), int(k), d.dtype, w is not None, i.dtype, d.is_cuda),
                   shapes)]
    sa.launches = 0
    try:
        small = fam_small_reference(torch, np)
        for arch, r in small.items():
            print(f"[families] 13a reduced {arch} (4 experts, d 256, moe_group 8; 3 federated rounds, C 4, "
                  f"then 2 central steps, C 4): card == CPU assignments {r['assign']}, cluster counts "
                  f"{r['counts']}; max |card - CPU| {r['errs']} within rtol 1e-4, atol 1e-5 + "
                  f"tests/test_torch_moe.py's floors; two card runs bit-identical (loss bits, float64 "
                  f"checksums of {r['n_leaves']} leaves x 2 modes); losses {r['losses']}", flush=True)
        qw = fam_qwen3_phase(torch)
        full = {arch: fam_full_depth(torch, arch) for arch in ("qwen2-vl-2b", "musicgen-large")}
    finally:
        for u in undo:
            u()
    launches = sa.launches
    # 13a: two card runs of 3 rounds x (2 clustering + a call per leaf) and
    # 2 central steps x 2; 13b, 13c: 2 a central step
    want = (2 * sum(3 * (2 + r["n_leaves"]) + 2 * 2 for r in small.values())
            + 2 * FAM_STEPS + 2 * len(full))
    shapes = {k[:5]: n for k, n in shapes.items() if k[5]}  # the card's calls
    if launches != want or launches != sum(shapes.values()):
        raise AssertionError(f"13: {launches} segment kernel launches, {sum(shapes.values())} calls on "
                             f"the card, want {want}")
    s_step = statistics.median(qw["secs"])
    flop_s = qw["flops"] / FP32_FLOPS
    print(f"[families] 13b {QWEN3_MOE} full width (d 4096, 64/4 heads, 128 experts top-8, d_ff 1536, vocab "
          f"151936, capacity 1.25, moe_group 256, f32), depth 1 of 94 ({qw['n_params']:,} params, experts "
          f"{qw['n_experts']:,}), make_central_train_step on {FAM_B} x {FAM_S} tokens (synth_corpus), "
          f"4 clients; {card}: init {qw['init_s']:.2f} s; s/step {[round(x, 4) for x in qw['secs']]}; "
          f"{qw['tokens'] / s_step:.1f} tokens/s (median step {s_step:.4f} s); loss {qw['losses']}; "
          f"cluster counts {qw['counts']}", flush=True)
    print(f"[families] 13b {card}: {qw['flops'] / 1e12:.3f} TFLOP a step = 8 x [(P - P_experts) x T + "
          f"3 x D x F x E x cap x G] with T {qw['tokens']}, G = T/256 = {qw['G']}, cap {qw['cap']}; bound "
          f"{flop_s:.4f} s at 67 TFLOP/s f32 = {100 * flop_s / s_step:.1f}% of the FLOP bound; peak memory "
          f"{qw['peak_gb']:.2f} GB (plan ~70 GB of 80; serving included {qw['peak_all_gb']:.2f} GB)",
          flush=True)
    print(f"[families] 13b MoE aux by step (lb_loss, z_loss, frac_dropped): "
          f"{[(round(a['lb_loss'], 5), round(a['z_loss'], 5), round(a['frac_dropped'], 5)) for a in qw['aux']]}",
          flush=True)
    st = qw["stage_ms"]
    # the experts read their weights and slots once and write their outputs
    ex_bound = bound(4 * (qw["n_experts"] + 2 * math.prod(qw["ein_shape"])), qw["expert_flops"])
    print(f"[families] 13b {card}: MoE stages of one forward on the layer's input ({FAM_B} x {FAM_S} "
          f"tokens, expert buffers {qw['ein_shape']}, frac_dropped {qw['stage_frac']:.5f}), CUDA events, "
          f"median of 5: router {st['router']:.3f} ms, dispatch {st['dispatch']:.3f} ms, experts "
          f"{st['experts']:.3f} ms (bound {ex_bound[0]:.3f} ms, {ex_bound[1]}), combine "
          f"{st['combine']:.3f} ms", flush=True)
    print(f"[families] 13b {card}: prefill 2 x {FAM_S} in {qw['prefill_s']:.4f} s; 8 served tokens "
          f"against a 1024-slot cache in {qw['serve_s']:.4f} s ({1e3 * qw['serve_s'] / 8:.2f} ms/token), "
          f"greedy {qw['served']}; all finite", flush=True)
    for arch, r in full.items():
        print(f"[families] 13c {arch} full width and depth ({r['n_params']:,} params, {r['n_layers']} "
              f"layers, f32), 2 x {r['seq']} positions, 2 clients; {card}: init {r['init_s']:.2f} s, "
              f"central step {r['step_s']:.4f} s (loss {r['loss']:.5f}), prefill {r['prefill_s']:.4f} s, "
              f"8 served tokens {r['serve_s']:.4f} s, greedy {r['served']}; peak {r['peak_gb']:.2f} GB; "
              f"all finite, shapes as the reference's", flush=True)
    # ------------------------------------------------ 13d: call shapes
    worst = 0.0
    for id_dtype in sorted({s[4] for s in shapes}, key=str):
        sigs = [s[:4] for s in shapes if s[4] == id_dtype]
        worst = max(worst, check_rows(torch, ops, ref, [], sigs, id_dtype)["segment_aggregate"])
    print(f"[families] segment call shapes of phase 13 {shapes}: {launches} kernel launches, none on the "
          f"plain version; each shape held against the plain version: max |err| {worst}", flush=True)
    return dict(launches=launches, worst=worst, qwen3=qw, full=full, small=small)


def families_only(torch) -> int:
    """``--families``: build, then phase 13 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import segment_aggregate as sa

    card = smi()
    print(card)
    so = build.build()
    print(f"[build] {so}")
    out = families_phase(torch, np, ops, ref, sa, card)
    print(json.dumps({"phase13_launches": out["launches"], "max_abs_err": out["worst"]}))
    print(card)
    return 0


# ------------------------------------------- phase 14: SSM and hybrid families
XLSTM, ZAMBA2 = "xlstm_1_3b", "zamba2_7b"
SSM_ROUNDS = 2  # 14b: the first round bootstraps the clustering, the second takes the EMA path
SSM_C, SSM_M, SSM_S = 2, 2, 512  # clients, sequences per client, tokens per sequence
SSM_STEPS = 2  # 14c central steps
ZAMBA2_DEPTH = 39  # of 81: 6 superblocks of 6 Mamba-2 layers (+ the shared block) and the 3-layer tail
SSM_SMALL_S = 32  # 14a tokens per sequence: two SSD chunks of 16
# 14a's margins, per tree and step: twice float32's own error against a
# float64 run of the port, as tests/test_torch_ssm_families.py measured it
# on this scenario (its configs, seeds and tokens; the larger of JAX's and
# the port's), on top of rtol 1e-4, atol 1e-5. zamba2's shared attention
# is nearly one-hot at the reduced width and FedYoGi's sign amplifies the
# rounding from round to round, so its later federated rounds carry more.
SSM_FLOORS = {
    (XLSTM, "A"): [{"params": 2.4e-5, "opt": 4.9e-7, "clust": 9.1e-4},
                   {"params": 3.9e-5, "opt": 1.5e-6, "clust": 9.7e-4},
                   {"params": 1.8e-4, "opt": 7.1e-6, "clust": 1.6e-3}],
    (XLSTM, "B"): [{"params": 9.2e-7, "opt": 9.2e-9, "clust": 4.8e-7},
                   {"params": 2.1e-6, "opt": 2.1e-8, "clust": 5.7e-7}],
    (ZAMBA2, "A"): [{"params": 5.7e-5, "opt": 2.3e-6, "clust": 9.6e-3},
                    {"params": 7.9e-3, "opt": 3.2e-4, "clust": 0.042},
                    {"params": 0.015, "opt": 5.1e-4, "clust": 0.22}],
    (ZAMBA2, "B"): [{"params": 1.6e-5, "opt": 1.6e-7, "clust": 1.8e-6},
                    {"params": 1.7e-3, "opt": 1.7e-5, "clust": 1.4e-5}],
}


def ssm_small_cfgs(arch):
    """14a's configs: the reduced config (attention in query chunks of 8, CE
    in chunks of 8) for the federated rounds (A) and the central steps (B);
    zamba2's B with 5 layers at attn_every 2 (two superblocks, the shared
    block applied twice, a tail layer), as in the tests."""
    from repro_torch.configs import get_config, reduce_config

    cfg = reduce_config(get_config(arch)).replace(attn_qchunk=8, ce_chunk=8)
    return {"A": cfg, "B": cfg.replace(n_layers=5, attn_every=2) if arch == ZAMBA2 else cfg}


def ssm_small_run(torch, np, arch, dev, seg_log):
    """14a, one run on ``dev``: 3 rounds of make_train_step (4 clients x 2 x
    32 tokens), then 2 steps of make_central_train_step (8 x 32 tokens, 4
    clients), each from params drawn on the CPU from key 5 (the tests'
    tokens, seeds 10-12 and 20-21). Every segment call's (K, D, ids) goes
    into ``seg_log``; each step's state is kept (float64 copies on the
    CPU)."""
    from repro_torch import random as rnd
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    cfgs = ssm_small_cfgs(arch)
    toks_a = [np.random.default_rng(10 + r).integers(0, cfgs["A"].vocab, (4, 2, SSM_SMALL_S)).astype(np.int32)
              for r in range(3)]
    toks_b = [np.random.default_rng(20 + r).integers(0, cfgs["B"].vocab, (8, SSM_SMALL_S)).astype(np.int32)
              for r in range(2)]
    undo = record(steps.kops, "segment_aggregate", lambda d, i, k, w=None: (int(k), d.shape[-1], i.cpu()),
                  seg_log)
    out = {}
    try:
        for mode, toks, make in (
                ("A", toks_a, lambda m: steps.make_train_step(m, steps.StepConfig(
                    local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32))),
                ("B", toks_b, lambda m: steps.make_central_train_step(
                    m, steps.StepConfig(server_lr=0.2, d_sketch=32), n_clients=4))):
            model = build_model(cfgs[mode])
            params = tree_map(lambda a: a.to(dev), model.init(rnd.key(5), device="cpu"))
            opt, clust = steps.yogi_init(params), steps.clustering_init(2, 32, device=dev)
            step, losses, counts, states = make(model), [], [], []
            for t in toks:
                params, opt, clust, met = step(params, opt, clust, {"tokens": torch.from_numpy(t).to(dev)})
                losses.append(float(met["loss"]))
                counts.append(met["cluster_counts"].tolist())
                states.append([tree_map(lambda a: a.detach().to("cpu", torch.float64, copy=True), s)
                               for s in (params, opt, clust)])
            out[mode] = dict(states=states, losses=losses, counts=counts)
    finally:
        undo()
    return out


def ssm_small_reference(torch, np):
    """14a: the reduced xlstm and zamba2 on the CPU and twice on the card.
    Card vs CPU: equal assignments and counts, every step's state within
    ``SSM_FLOORS``; the two card runs bit-identical."""
    from repro_torch.utils.tree import leaves, leaves_with_path

    report = {}
    for arch in (XLSTM, ZAMBA2):
        logs = {run: [] for run in ("cpu", "cuda", "cuda2")}
        runs = {run: ssm_small_run(torch, np, arch, run.rstrip("2"), logs[run]) for run in logs}
        cpu, card = runs["cpu"], runs["cuda"]
        if ([(k, d) for k, d, _ in logs["cuda"]] != [(k, d) for k, d, _ in logs["cpu"]]
                or not all(torch.equal(a[2], b[2]) for a, b in zip(logs["cuda"], logs["cpu"]))
                or any(card[m]["counts"] != cpu[m]["counts"] for m in "AB")):
            raise AssertionError(f"14a {arch}: assignments or counts differ card vs CPU: "
                                 f"{[card[m]['counts'] for m in 'AB']} vs {[cpu[m]['counts'] for m in 'AB']}")
        errs = {}
        for m in "AB":
            for r, (got_r, want_r) in enumerate(zip(card[m]["states"], cpu[m]["states"])):
                for name, got, want in zip(("params", "opt", "clust"), got_r, want_r):
                    want, floor = dict(leaves_with_path(want)), SSM_FLOORS[(arch, m)][r][name]
                    for k, v in leaves_with_path(got):
                        err = (v - want[k]).abs().max().item()
                        errs[f"{m} {name}"] = max(errs.get(f"{m} {name}", 0.0), err)
                        if not torch.allclose(v, want[k], rtol=1e-4, atol=1e-5 + floor):
                            raise AssertionError(f"14a {arch} mode {m} step {r}: {name} {k} differs card vs CPU "
                                                 f"by {err} (margin: rtol 1e-4, atol 1e-5 + {floor})")

        def digest(run):
            return ([float.hex(x) for m in "AB" for x in run[m]["losses"]],
                    [float(a.sum()) for m in "AB" for s in run[m]["states"] for t in s for a in leaves(t)])

        if digest(card) != digest(runs["cuda2"]):
            raise AssertionError(f"14a {arch}: two card runs from the same state differ")
        n_leaves = {m: len(leaves(card[m]["states"][0][0])) for m in "AB"}
        ag = [i[0].tolist() for k, d, i in logs["cuda"] if k > 1 and d > 1]
        report[arch] = dict(errs=errs, assign=ag, counts=[card[m]["counts"] for m in "AB"],
                            losses=[card[m]["losses"] for m in "AB"], n_leaves=n_leaves)
        del runs
    return report


def ssm_decode_check(torch, np, arch):
    """14a: the chunked forward against token-by-token decode on the card
    (the reduced config, full attention, B 2 x 8 tokens): the logits agree
    at tests/test_models.py's 5e-3 (the recurrence against its chunked
    form)."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model

    model = build_model(reduce_config(get_config(arch)).replace(attn_qchunk=0))
    params = model.init(rnd.key(0), device="cuda")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, model.cfg.vocab, (2, 8)).astype(np.int32)).cuda()
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": tok})
        cache = model.init_cache(2, 8, device="cuda")
        outs = []
        for t in range(8):
            logits, cache = model.decode_step(params, tok[:, t:t + 1], cache)
            outs.append(logits)
    dec = torch.cat(outs, dim=1)
    err = (dec - full).abs().max().item()
    if not torch.allclose(dec, full, rtol=5e-3, atol=5e-3):
        raise AssertionError(f"14a {arch}: decode differs from the chunked forward by {err}")
    return err


def slstm_probe(torch, params, cfg):
    """14b: one sLSTM layer of the round at a client step's shape (1 x 512
    tokens): its forward's aten ops on the card (one launch or more each),
    and the host seconds of a forward alone and of a forward and backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import ssm
    from repro_torch.utils.tree import leaves, tree_map

    p = tree_map(lambda a: a[-1].detach().clone().requires_grad_(True), params["backbone"]["slstm"])
    x = torch.randn((1, SSM_S, cfg.d_model), device="cuda", requires_grad=True)

    def fwd():
        with torch.no_grad():
            return ssm.slstm_apply(p, cfg, x)

    def fwd_bwd():
        return torch.autograd.grad(ssm.slstm_apply(p, cfg, x).sum(), [x] + leaves(p))

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    secs = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    with Count():
        fwd()
    torch.cuda.synchronize()
    return dict(secs=secs, fwd_ops=Count.n)


def ssm_xlstm_phase(torch):
    """14b: xlstm-1.3b at full width and depth (float32, seed 0): 2
    federated rounds of make_train_step with 2 clients x 2 x 512 tokens,
    the sLSTM probe, then a prefill of 2 x 512 and 8 served tokens."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.core.sketch import GradientSketcher
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves

    model = build_model(get_config(XLSTM))
    cfg = model.cfg
    if (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.slstm_every, cfg.ssm_expand, cfg.vocab) != (
            2048, 48, 4, 8, 2, 50304):
        raise AssertionError(f"14b: {XLSTM} is not at its published width and depth: {cfg}")
    n_params = model.param_count()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(rnd.key(0), device="cuda")
    opt = steps.yogi_init(params)
    clust = steps.clustering_init(2, 128, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sc = steps.StepConfig(local_steps=2, d_sketch=128)
    step = steps.make_train_step(model, sc)
    toks_np, groups = synth_corpus(SSM_C, SSM_M, SSM_S, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks_np).cuda()}
    sk_log, agg_log = [], []
    undo = [record(GradientSketcher, "batch", lambda self, u: "sketch", sk_log, torch),
            record(steps.kops, "segment_aggregate",
                   lambda d, i, k, w=None: (tuple(d.shape), int(k), w is not None), agg_log, torch)]
    # each client SGD step's global-norm clip scale (0-dim tensors, read
    # after the rounds)
    scales, clip = [], steps._clip_scale
    steps._clip_scale = lambda grads, c: scales.append(clip(grads, c)) or scales[-1]
    undo.append(lambda: setattr(steps, "_clip_scale", clip))
    secs, losses, counts = [], [], []
    launches0 = sa.launches
    try:
        for _ in range(SSM_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, clust, met = step(params, opt, clust, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            counts.append(met["cluster_counts"].tolist())
    finally:
        for u in undo:
            u()
    launches = sa.launches - launches0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaves = len(leaves(params))
    if not all(math.isfinite(v) for v in losses) or not all(bool(torch.isfinite(a).all()) for a in leaves(params)):
        raise AssertionError(f"14b: non-finite loss {losses} or params")
    if any(sum(c) != SSM_C for c in counts):
        raise AssertionError(f"14b: cluster counts {counts} do not sum to {SSM_C}")
    if launches != SSM_ROUNDS * (2 + n_leaves) or len(agg_log) != launches:
        raise AssertionError(f"14b: {launches} segment kernel launches and {len(agg_log)} calls, want "
                             f"{SSM_ROUNDS} x (2 + {n_leaves})")
    agg = {}
    for sig, a, b in agg_log:
        agg.setdefault(sig, []).append(a.elapsed_time(b))
    tokens = SSM_C * SSM_M * SSM_S
    n_embed = cfg.padded_vocab * cfg.d_model  # a gather, not a product
    flops = 8 * (n_params - n_embed) * tokens  # forward, backward and the forward recompute
    # the last-block sketch's values: l[-1] of every backbone leaf (the
    # last group), the head and the final norm
    n_last = (sum(a[-1].numel() for a in leaves(params["backbone"]) if a.dim() >= 2)
              + params["head"].numel() + params["final_norm"]["scale"].numel())
    probe = slstm_probe(torch, params, cfg)

    prompt = batch["tokens"][:, 0]  # (2, 512): each client's first sequence
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = steps.make_prefill_step(model, sc)(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if tuple(last.shape) != (2, 1, cfg.padded_vocab) or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"14b: prefill logits {tuple(last.shape)} not finite")
    served, serve_s = serve_tokens(torch, model, params, prompt[:, :1], steps)
    peak_all = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, step, last, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, init_s=init_s, secs=secs, losses=losses, counts=counts,
                scales=[float(x) for x in scales], groups=groups.tolist(), launches=launches, n_leaves=n_leaves, peak_gb=peak_gb,
                peak_all_gb=peak_all, tokens=tokens, flops=flops, sk_ms=[a.elapsed_time(b) for _, a, b in sk_log],
                n_last=n_last, agg=agg, probe=probe, prefill_s=prefill_s, serve_s=serve_s, served=served)


def ssm_zamba2_phase(torch):
    """14c: zamba2-7b at full width, depth 39 of 81 (float32, seed 0): 2
    central steps on 4 x 512 tokens, then a prefill of 2 x 512 and 8 served
    tokens."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model, transformer
    from repro_torch.utils.tree import leaves

    full = get_config(ZAMBA2)
    model = build_model(full.replace(n_layers=ZAMBA2_DEPTH))
    cfg = model.cfg
    if (cfg.d_model, cfg.n_heads, cfg.ssm_heads, cfg.ssm_state, cfg.d_ff, cfg.vocab, cfg.attn_every) != (
            3584, 32, 112, 64, 14336, 32000, 6):
        raise AssertionError(f"14c: {ZAMBA2} is not at its published width: {cfg}")
    stacks = transformer.block_stacks(cfg)
    n_params = model.param_count()
    n_shared = sum(a.numel() for a in leaves(model.init_shapes()["backbone"]["shared_attn"]))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(rnd.key(0), device="cuda")
    opt = steps.yogi_init(params)
    clust = steps.clustering_init(2, 128, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = steps.make_central_train_step(model, steps.StepConfig(d_sketch=128), n_clients=FAM_B)
    toks = torch.from_numpy(synth_corpus(FAM_B, 1, SSM_S, cfg.vocab)[0].reshape(FAM_B, SSM_S)).cuda()
    secs, losses, counts = [], [], []
    for _ in range(SSM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, clust, met = step(params, opt, clust, {"tokens": toks})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        counts.append(met["cluster_counts"].tolist())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses) or not all(bool(torch.isfinite(a).all()) for a in leaves(params)):
        raise AssertionError(f"14c: non-finite loss {losses} or params")
    if any(sum(c) != FAM_B for c in counts):
        raise AssertionError(f"14c: cluster counts {counts} do not sum to {FAM_B}")
    T = FAM_B * SSM_S
    n_super = stacks["mamba"][0]
    # the shared block counts once per application; the embedding is a gather
    flops = 8 * (n_params - cfg.padded_vocab * cfg.d_model + (n_super - 1) * n_shared) * T
    prompt = toks[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = steps.make_prefill_step(model, steps.StepConfig())(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if tuple(last.shape) != (2, 1, cfg.padded_vocab) or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"14c: prefill logits {tuple(last.shape)} not finite")
    served, serve_s = serve_tokens(torch, model, params, prompt[:, :1], steps)
    peak_all = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, step, last
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, n_full=build_model(full).param_count(), stacks=stacks, n_shared=n_shared,
                init_s=init_s, secs=secs, losses=losses, counts=counts, peak_gb=peak_gb, peak_all_gb=peak_all,
                tokens=T, flops=flops, prefill_s=prefill_s, serve_s=serve_s, served=served)


def ssm_phase(torch, np, ops, ref, sa, card) -> dict:
    """Phase 14 (after phase 13 has freed its memory): 14a reduced xlstm and
    zamba2 card vs CPU and card vs card, decode vs the chunked forward; 14b
    xlstm-1.3b's federated round at full width and depth; 14c zamba2-7b's
    central step at full width, depth 39; 14d every segment call shape of
    the phase held against the plain version, and the largest timed. The
    plain versions raise on CUDA tensors throughout; the segment launches
    of 14a-14c are counted from 0."""
    from repro_torch.launch import steps

    gc.collect()
    torch.cuda.empty_cache()
    shapes = {}
    undo = [forbid_cuda_in_plain(torch, ref),
            record(steps.kops, "segment_aggregate",
                   lambda d, i, k, w=None: (tuple(d.shape), int(k), d.dtype, w is not None, i.dtype, d.is_cuda),
                   shapes)]
    sa.launches = 0
    t_phase = time.perf_counter()
    try:
        small = ssm_small_reference(torch, np)
        for arch, r in small.items():
            print(f"[ssm] 14a reduced {arch} (d 256, ssm_chunk 16; 3 federated rounds, C 4 x 2 x "
                  f"{SSM_SMALL_S} tokens, then 2 central steps, C 4{', 5 layers at attn_every 2' if arch == ZAMBA2 else ''}): "
                  f"card == CPU assignments {r['assign']}, cluster counts {r['counts']}; max |card - CPU| "
                  f"{r['errs']} within rtol 1e-4, atol 1e-5 + twice float32's own error per tree and step "
                  f"(tests/test_torch_ssm_families.py's measurement); two "
                  f"card runs bit-identical (loss bits, float64 checksums of every leaf after every step); "
                  f"losses {r['losses']}", flush=True)
        for arch in (XLSTM, ZAMBA2):
            err = ssm_decode_check(torch, np, arch)
            print(f"[ssm] 14a reduced {arch}: 8 tokens decoded one at a time against the chunked forward "
                  f"on the card: max |err| {err:.3e} (tests/test_models.py's 5e-3)", flush=True)
        xl = ssm_xlstm_phase(torch)
        zb = ssm_zamba2_phase(torch)
    finally:
        for u in undo:
            u()
    launches = sa.launches
    # 14a: two card runs of 3 rounds x (2 clustering + a call per leaf) and
    # 2 central steps x 2; 14b a round 2 + a call per leaf; 14c 2 a step
    want = (2 * sum(3 * (2 + r["n_leaves"]["A"]) + 2 * 2 for r in small.values())
            + SSM_ROUNDS * (2 + xl["n_leaves"]) + 2 * SSM_STEPS)
    shapes = {k[:5]: n for k, n in shapes.items() if k[5]}  # the card's calls
    if launches != want or launches != sum(shapes.values()):
        raise AssertionError(f"14: {launches} segment kernel launches, {sum(shapes.values())} calls on the card, "
                             f"want {want}")
    s_round = statistics.median(xl["secs"])
    flop_s = xl["flops"] / FP32_FLOPS
    print(f"[ssm] 14b {XLSTM} full width and depth ({xl['n_params']:,} params, f32, 6 groups of 7 mLSTM + 1 "
          f"sLSTM, d 2048, 4 heads, ssm_chunk 256), {SSM_C} clients x {SSM_M} x {SSM_S} tokens (synth_corpus "
          f"groups {xl['groups']}), local_steps 2, d_sketch 128; {card}: init {xl['init_s']:.2f} s; s/round "
          f"{[round(x, 4) for x in xl['secs']]}; loss by round {[round(x, 5) for x in xl['losses']]}; cluster "
          f"counts {xl['counts']}; the clip scale of each client SGD step {xl['scales']} (0 where the float32 "
          f"global norm of the gradients overflows)", flush=True)
    print(f"[ssm] 14b {card}: {xl['tokens'] / s_round:.1f} tokens/s (median round {s_round:.4f} s); "
          f"{xl['flops'] / 1e12:.3f} TFLOP a round (8 x (P - embedding) x {xl['tokens']} tokens) bound "
          f"{flop_s:.4f} s at 67 TFLOP/s f32 = {100 * flop_s / s_round:.1f}% of the FLOP bound; peak memory "
          f"{xl['peak_gb']:.2f} GB (serving included {xl['peak_all_gb']:.2f} GB)", flush=True)
    print(f"[ssm] 14b {card}: sketch per round {[round(x / 1e3, 3) for x in xl['sk_ms']]} s of device time "
          f"({SSM_C} x {xl['n_last']:,} last-group and head values; the clients share the "
          f"{xl['n_last'] * 128 / 1e9:.1f}G Rademacher draws of a round)", flush=True)
    pr = xl["probe"]
    print(f"[ssm] 14b {card}: one sLSTM layer at 1 x {SSM_S} tokens: {pr['fwd_ops']} aten ops on the card "
          f"in its forward ({pr['fwd_ops'] / SSM_S:.1f} a time step), forward {pr['secs']['fwd']:.4f} s, forward "
          f"+ backward {pr['secs']['fwd_bwd']:.4f} s; x 6 layers x 4 client SGD steps = "
          f"{24 * pr['secs']['fwd_bwd']:.3f} s = {100 * 24 * pr['secs']['fwd_bwd'] / s_round:.1f}% of the median "
          f"round", flush=True)
    for sig, ms in sorted(xl["agg"].items(), key=lambda kv: -math.prod(kv[0][0])):
        (C, P, D), K, w = sig
        b = bound(C * P * D * 4 + C * P * (8 if w else 4) + C * K * D * 4, C * P * D * (2 if w else 1))
        print(f"[ssm] 14b segment call {sig} x{len(ms)}: {statistics.median(ms):.4f} ms median (events, in "
              f"the step) against its bound {b[0]:.4f} ms ({b[1]})", flush=True)
    print(f"[ssm] 14b {card}: prefill 2 x {SSM_S} in {xl['prefill_s']:.4f} s; 8 served tokens against a "
          f"fresh cache in {xl['serve_s']:.4f} s ({1e3 * xl['serve_s'] / 8:.2f} ms/token), greedy "
          f"{xl['served']}; all finite", flush=True)
    s_step = statistics.median(zb["secs"])
    zflop_s = zb["flops"] / FP32_FLOPS
    print(f"[ssm] 14c {ZAMBA2} full width (d 3584, 112 SSM heads of 64, state 64, shared block 32 heads, "
          f"d_ff 14336), depth {ZAMBA2_DEPTH} of 81 (stacks {zb['stacks']}; {zb['n_params']:,} params of "
          f"{zb['n_full']:,}; the cut: 81 layers' central step needs ~108 GB), make_central_train_step on "
          f"{FAM_B} x {SSM_S} tokens, 4 clients; {card}: init {zb['init_s']:.2f} s; s/step "
          f"{[round(x, 4) for x in zb['secs']]}; {zb['tokens'] / s_step:.1f} tokens/s; loss {zb['losses']}; "
          f"cluster counts {zb['counts']}", flush=True)
    print(f"[ssm] 14c {card}: {zb['flops'] / 1e12:.3f} TFLOP a step (8 x (P - embedding + "
          f"{zb['stacks']['mamba'][0] - 1} x {zb['n_shared']:,} shared-block params applied again) x "
          f"{zb['tokens']}) bound {zflop_s:.4f} s = {100 * zflop_s / s_step:.1f}% of the FLOP bound; peak "
          f"memory {zb['peak_gb']:.2f} GB (serving included {zb['peak_all_gb']:.2f} GB); prefill 2 x {SSM_S} "
          f"in {zb['prefill_s']:.4f} s; 8 served tokens in {zb['serve_s']:.4f} s "
          f"({1e3 * zb['serve_s'] / 8:.2f} ms/token), greedy {zb['served']}; all finite", flush=True)
    # ------------------------------------------------ 14d: call shapes
    worst = 0.0
    for id_dtype in sorted({s[4] for s in shapes}, key=str):
        sigs = [s[:4] for s in shapes if s[4] == id_dtype]
        worst = max(worst, check_rows(torch, ops, ref, [], sigs, id_dtype)["segment_aggregate"])
    print(f"[ssm] segment call shapes of phase 14 {shapes}: {launches} kernel launches, none on the plain "
          f"version; each shape held against the plain version: max |err| {worst}", flush=True)
    largest = max((s[:4] for s in shapes), key=lambda s: math.prod(s[0]))
    t = time_segment(torch, ops, ref, largest, id_dtype=torch.int32, inner=3, reps=5)
    print_row("segment_aggregate", f"phase 14's largest call {largest}", t)
    print(f"[ssm] phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, worst=worst, row=row_json(largest, t))


def ssm_only(torch) -> int:
    """``--ssm``: build, then phase 14 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import segment_aggregate as sa

    card = smi()
    print(card)
    so = build.build()
    print(f"[build] {so}")
    out = ssm_phase(torch, np, ops, ref, sa, card)
    print(json.dumps({"phase14_launches": out["launches"], "max_abs_err": out["worst"], "row": out["row"]}))
    print(card)
    return 0


# ------------------------------------------- phase 15: cohort placement
# tests/test_cohort_sharding.py's C = 32 scenario (800 clients, 128 a round,
# 32 forced leaves): at 8 shards, capacity 64, 8 slots and 40 rows a shard
C32_POP = dict(n_clients=800, n_groups=8, group_sep=0.0, dirichlet=2.0, label_conflict=0.6, seed=13)
C32_FL = dict(rounds=4, participants_per_round=128, use_availability=False, seed=13)
C32_AUXO = dict(d_sketch=32, cluster_k=2, max_cohorts=32, clustering_start_frac=0.0,
                partition_start_frac=2.0, partition_end_frac=2.0)
C32_SHARDS, C32_ROUNDS = 8, 3
MAIN_SHARDS = 4  # 15b: phase 4's run at 4 shards
# benchmarks/elastic_restore.py's scenario (tests/conftest.py elastic_scenario):
# 300 clients, 60 a round (75 rows), max_cohorts 3, a save/load every 5 of 30 rounds
ELASTIC_POP = MODES_POP
ELASTIC_AUXO = MODES_AUXO
ELASTIC_ROUNDS, ELASTIC_EVERY, ELASTIC_WIDTH = 30, 5, 75
REMESH_K, REMESH_R = 8, 24  # tests/test_elastic_restore.py's remesh case
CROSS_K, CROSS_R = 6, 12  # CPU checkpoint -> card: the 12-round whole-run tolerance


def force_leaves(eng, n_leaves: int):
    """benchmarks/round_latency.py's force_leaves, for the port: grow the
    tree to ``n_leaves`` by unconditional binary partitions."""
    from repro_torch.core.clustering import OnlineClustering
    from repro_torch.core.coordinator import CohortStats, PartitionEvent

    co = eng.coordinator
    while len(co.tree.leaves()) < n_leaves:
        leaf = co.tree.leaves()[0]
        children = co.tree.partition(leaf, co.cluster_k)
        for ch in children:
            co.clusterers[ch] = OnlineClustering(co.cluster_k, co.d_sketch,
                                                 seed=co.seed + hash(ch) % 10_000, device=co.device)
            co.stats[ch] = CohortStats()
        event = PartitionEvent(parent=leaf, children=children, round_idx=0,
                               cluster_to_child={i: ch for i, ch in enumerate(children)})
        eng.pipeline.bank.spawn_children(event.parent, event.children)
        eng.pipeline.table.seed_children(eng.pipeline.bank.slot_of[event.parent],
                                         [eng.pipeline.bank.slot_of[ch] for ch in event.children])
        co.partitions.append(event)


def placement_engine(pop, fl, auxo, shards: int = 0, device: str = "cuda", **fl_kw):
    """An engine whose ``shards`` logical cohort shards all sit on card 0
    (or on the CPU)."""
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    devices = [f"{device}:0"] * shards if shards > 1 and device == "cuda" else None
    return AuxoEngine(MLPTask(dim=pop.dim, n_classes=pop.n_classes), pop,
                      FLConfig(**{**fl, **fl_kw}, cohort_shards=shards), AuxoConfig(**auxo),
                      device=device, devices=devices)


def elastic_engine(pop, rounds: int, overlap: int = 0, shards: int = 0, device: str = "cuda"):
    fl = dict(MODES_FL, rounds=rounds, eval_every=rounds - 1, round_overlap=overlap,
              rows_per_shard=ELASTIC_WIDTH if shards > 1 else 0)
    return placement_engine(pop, fl, ELASTIC_AUXO, shards, device)


def run_digest(torch, eng, eval_round=None) -> dict:
    """tests/test_torch_run_state.py's digest on host numpy: every cohort's
    params, optimizer state and clocks by cohort id, the tables in sorted
    cohort-id column order, fingerprints, the global mean, the leaves, and
    with ``eval_round`` the per-client evaluation."""
    import numpy as np

    from repro_torch.utils.tree import leaves

    bank = eng.pipeline.bank
    out = {}
    for cid, slot in bank.slot_of.items():
        out[f"params:{cid}"] = np.concatenate(
            [v.cpu().numpy().ravel() for v in leaves(bank.params_of(cid))])
        out[f"opt:{cid}"] = np.concatenate(
            [v.cpu().numpy().ravel() for v in leaves(bank.opt_state_of(cid))])
        out[f"clock:{cid}"] = np.asarray([bank.clock[slot], float(bank.rounds[slot])])
    t = eng.pipeline.table
    cols = [bank.slot_of[c] for c in sorted(bank.slot_of)]
    out["table:reward"] = t.reward[:, cols]
    out["table:known"] = t.known[:, cols]
    out["table:cluster"] = t.cluster_idx[:, cols]
    out["fp"] = np.concatenate([eng.fingerprint.ravel(), eng.fp_seen, eng.neg_streak])
    out["mu"] = np.asarray(eng.global_mu)
    out["leaves"] = np.frombuffer(",".join(eng.coordinator.tree.leaves()).encode(), np.uint8)
    if eval_round is not None:
        out["eval"] = np.asarray(eng.evaluate(eval_round)["per_client"])
    return out


def digest_gap(da, db) -> tuple:
    """(keys that differ in bits, largest |difference| of the params and
    optimizer states, keys of discrete state that differ: leaves, clocks,
    known records and cluster indices)."""
    import numpy as np

    if set(da) != set(db):
        return sorted(set(da) ^ set(db)), float("inf"), ["keys"]
    diff = [k for k in sorted(da) if not np.array_equal(da[k], db[k])]
    gap = max([float(np.max(np.abs(da[k] - db[k]))) for k in diff
               if k.startswith(("params:", "opt:"))] + [0.0])
    bad = [k for k in diff if k.startswith(("leaves", "clock:", "table:known", "table:cluster"))]
    return diff, gap, bad


def params_close(torch, ea, eb, rtol, atol) -> float:
    """Largest |difference| of every cohort's params, engine to engine; raises
    past the tolerance."""
    gap = 0.0
    for cid in ea.pipeline.bank.slot_of:
        for k, v in ea.pipeline.bank.params_of(cid).items():
            w = eb.pipeline.bank.params_of(cid)[k].to(v.device)
            if not torch.allclose(w, v, rtol=rtol, atol=atol):
                raise AssertionError(f"{cid}/{k} differs past rtol {rtol}, atol {atol}")
            gap = max(gap, (w - v).abs().max().item())
    return gap


def preempted_run(torch, pop, overlap: int, tmp: str):
    """benchmarks/elastic_restore.py: save, drop and load the engine every
    ELASTIC_EVERY rounds; returns (engine, [save s], [load s], wall s)."""
    import shutil

    from repro_torch.checkpoint import load_run, save_run

    eng = elastic_engine(pop, ELASTIC_ROUNDS, overlap)
    saves, loads = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(ELASTIC_ROUNDS):
        eng.step(r)
        if (r + 1) % ELASTIC_EVERY == 0 and r + 1 < ELASTIC_ROUNDS:
            d = os.path.join(tmp, f"o{overlap}r{r + 1}")
            t1 = time.perf_counter()
            save_run(d, eng)
            t2 = time.perf_counter()
            del eng  # the preemption: nothing survives but the files
            eng = load_run(d, device="cuda")
            t3 = time.perf_counter()
            if eng.round_cursor != r + 1:
                raise AssertionError(f"round cursor {eng.round_cursor} after round {r + 1}")
            saves.append(t2 - t1)
            loads.append(t3 - t2)
            shutil.rmtree(d)
    eng.pipeline.flush()
    torch.cuda.synchronize()
    return eng, saves, loads, time.perf_counter() - t0


def uninterrupted_run(torch, pop, overlap: int):
    eng = elastic_engine(pop, ELASTIC_ROUNDS, overlap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(ELASTIC_ROUNDS):
        if r and r % ELASTIC_EVERY == 0:
            eng.pipeline.flush()  # the same drain points as the preempted run
        eng.step(r)
    eng.pipeline.flush()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def continuous(pop, k: int, rounds: int, shards: int = 0, device: str = "cuda"):
    """tests/test_elastic_restore.py's comparator: flushed at round k and at the end."""
    eng = elastic_engine(pop, rounds, 0, shards, device)
    for r in range(rounds):
        if r == k:
            eng.pipeline.flush()
        eng.step(r)
    eng.pipeline.flush()
    return eng


def resumed(eng, rounds: int):
    for r in range(eng.round_cursor, rounds):
        eng.step(r)
    eng.pipeline.flush()
    return eng


# 15c's layout gate: where one segment's 25 rows sit, as (C, P, block, first
# row): offsets 0 and 37, blocks 1 and 3 of a stacked call, and rows that
# straddle rows 256, 512 and 1024 (the 256-row chunk boundaries of an earlier design)
LAYOUT_PLACES = [(1, 75, 0, 0), (1, 75, 0, 37), (2, 75, 1, 11), (4, 75, 3, 50),
                 (1, 500, 0, 240), (1, 600, 0, 500), (1, 2000, 0, 1020)]


def layout_free_sums(torch, ops, ref) -> dict:
    """15c's gate: one segment's 25 rows summed at every placement of
    LAYOUT_PLACES, inside calls whose other rows are random (segment 1 or
    dropped). Every call must give the plain version's bits on a CPU copy
    of its inputs (``torch.equal`` on the int32 views), so the segment's sum
    has the same bits wherever it sits. D = 1 (stage ②'s denominators:
    integer client sizes, q-FedAvg's real loss weights), the main path's
    D = 6922 weighted (rows 8 bytes off at odd rows), and a D = 512 call
    (4 column spans a segment); f32 and bf16 data. Raises on any
    difference."""
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = 25
    cases = {  # name: (values, weights or None)
        "narrow, integer sizes": (torch.randint(20, 500, (rows, 1), generator=g, device="cuda").float(), None),
        "narrow, real values": (torch.rand(rows, 1, generator=g, device="cuda"), None),
        "narrow, real weights": (torch.randn(rows, 1, generator=g, device="cuda"),
                                 torch.rand(rows, generator=g, device="cuda")),
        "wide, real weights": (torch.randn(rows, 6922, generator=g, device="cuda"),
                               torch.rand(rows, generator=g, device="cuda")),
        "D = 512, real weights": (torch.randn(rows, 512, generator=g, device="cuda"),
                                     torch.rand(rows, generator=g, device="cuda")),
    }
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    out = {}
    for name, (d, w) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            sums = []
            for C, P, blk, off in LAYOUT_PLACES:
                D = d.shape[1]
                data = torch.randn(C, P, D, generator=g, device="cuda").to(dt)
                ids = torch.where(torch.rand(C, P, generator=g, device="cuda") < 0.2, -1, 1)
                wt = torch.rand(C, P, generator=g, device="cuda")
                data[blk, off:off + rows] = d.to(dt)
                ids[blk, off:off + rows] = 0
                wt[blk, off:off + rows] = 1.0 if w is None else w
                wt = None if w is None else wt
                got = ops.segment_aggregate(data, ids, 2, wt)
                want = ref.segment_aggregate(data.cpu(), ids.cpu(), 2, None if wt is None else wt.cpu())
                if not torch.equal(bits(got.cpu()), bits(want)):
                    n = int((bits(got.cpu()) != bits(want)).sum())
                    raise AssertionError(
                        f"15c layout: {name} {dt} at (C, P, block, row) {(C, P, blk, off)}: {n} "
                        f"elements differ from the plain version's bits, max |diff| "
                        f"{(got.cpu() - want).abs().max().item():.3e}")
                sums.append(got[blk, 0])
            if not all(torch.equal(bits(s), bits(sums[0])) for s in sums[1:]):
                raise AssertionError(f"15c layout: {name} {dt}: the segment's sum differs between placements")
            out[f"{name}, {str(dt).split('.')[-1]}"] = len(sums)
    return out


def placement_phase(torch, np, ops, ref, cs, sa) -> dict:
    """Phase 15: the sharded CohortBank and its collective-free round (S
    logical shards on card 0) and whole-run checkpoints with remesh. Plain
    versions raise on CUDA tensors throughout; every path's launches are
    counted."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import load_run, save_run
    from repro_torch.data import make_population

    counts = Launches(cs, sa)
    shapes = {"cosine_similarity": {}, "segment_aggregate": {}}
    undo = [
        record(cs, "cosine_similarity",
               lambda x, c, eps=1e-8: (tuple(x.shape), tuple(c.shape), x.dtype),
               shapes["cosine_similarity"]),
        record(sa, "segment_aggregate",
               lambda d, i, k, w=None: (tuple(d.shape), int(k), d.dtype, w is not None),
               shapes["segment_aggregate"]),
        forbid_cuda_in_plain(torch, ref),
    ]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="placement-", dir=os.path.join(ROOT, "build"))
    secs = {}
    out = {}
    try:
        # ------------------------------------ 15a: 8 shards against one device
        t15 = time.perf_counter()
        pop = make_population(**C32_POP)
        runs = {}
        for shards in (0, C32_SHARDS):
            eng = placement_engine(pop, C32_FL, C32_AUXO, shards)
            force_leaves(eng, 32)
            with counts(f"15a C32 S={max(1, shards)}"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for r in range(C32_ROUNDS):
                    eng.step(r)
                torch.cuda.synchronize()
            runs[shards] = (eng, (time.perf_counter() - t0) / C32_ROUNDS)
        (single, s_single), (sharded, s_sharded) = runs[0], runs[C32_SHARDS]
        p = sharded.pipeline
        if single.coordinator.tree.leaves() != sharded.coordinator.tree.leaves():
            raise AssertionError("15a: leaves differ between 8 shards and one device")
        if p.exec_dispatches != C32_ROUNDS or p.dropped_rows != 0:
            raise AssertionError(f"15a: dispatches {p.exec_dispatches}, dropped {p.dropped_rows}")
        gap = params_close(torch, single, sharded, 1e-5, 1e-5)
        same = not digest_gap(run_digest(torch, single), run_digest(torch, sharded))[0]
        print(f"[placement] 15a C=32 (800 clients, 128 a round, 32 forced leaves), {C32_ROUNDS} "
              f"rounds at {C32_SHARDS} logical shards on one card (capacity {p.bank.capacity}, "
              f"{p.bank.slots_per_shard} slots and {p.shard_width} rows a shard, "
              f"{len(p.bank.groups)} device group) vs one device: equal leaves; params max |diff| "
              f"{gap:.3e} (rtol 1e-5, atol 1e-5), bit-equal {same}; dispatches "
              f"{p.exec_dispatches}, dropped rows {p.dropped_rows}; s/round {s_sharded:.4f} "
              f"sharded vs {s_single:.4f} one device", flush=True)
        width = p.width
        del runs, single, sharded, p
        # the reference's probe: a partition after the first step, children
        # in other shard blocks. One leaf takes the whole round budget, so
        # the blocks get the full width (no drops) to match one device.
        probes = {}
        for shards in (0, C32_SHARDS):
            eng = placement_engine(pop, C32_FL, C32_AUXO, shards,
                                   rows_per_shard=width if shards else 0)
            with counts(f"15a probe S={max(1, shards)}"):
                eng.step(0)
                force_leaves(eng, 2)
                for r in (1, 2):
                    eng.step(r)
            probes[shards] = eng
        bank = probes[C32_SHARDS].pipeline.bank
        kid_shards = sorted(bank.shard_of(bank.slot_of[c]) for c in ("0.0", "0.1"))
        if kid_shards == [0, 0] or probes[C32_SHARDS].pipeline.exec_dispatches != 3:
            raise AssertionError(f"15a probe: children in shards {kid_shards}")
        gap = params_close(torch, probes[0], probes[C32_SHARDS], 1e-5, 1e-5)
        print(f"[placement] 15a spawn after the first step ({C32_SHARDS} shards of "
              f"{width} rows): children in shards {kid_shards}, 2 more rounds; params vs one "
              f"device max |diff| {gap:.3e}", flush=True)
        del probes
        secs["15a"] = time.perf_counter() - t15

        # ------------------------------ 15b: the main path at 4 shards
        t15 = time.perf_counter()
        with counts("15b main S=1"):
            base, hist, s1 = run_main(torch, ROUNDS)
        full_rows = base.pipeline.width
        with counts(f"15b main S={MAIN_SHARDS} rows {full_rows}"):
            full, hist_f, s_full = run_main(torch, ROUNDS, devices=["cuda:0"] * MAIN_SHARDS,
                                            cohort_shards=MAIN_SHARDS, rows_per_shard=full_rows)
        pb, pf = bank_digest(base)[0], bank_digest(full)[0]
        if pb != pf or base.coordinator.tree.leaves() != full.coordinator.tree.leaves():
            raise AssertionError(f"15b: partitions {pf} at {MAIN_SHARDS} shards vs {pb}")
        diff, gap, _ = digest_gap(run_digest(torch, base), run_digest(torch, full))
        with counts(f"15b main S={MAIN_SHARDS} auto"):
            auto, hist_a, s_auto = run_main(torch, ROUNDS, devices=["cuda:0"] * MAIN_SHARDS,
                                            cohort_shards=MAIN_SHARDS)
        pa = auto.pipeline
        print(f"[placement] 15b run_auxo openimage-like, {ROUNDS} rounds: one device "
              f"{s1 / ROUNDS:.4f} s/round; {MAIN_SHARDS} shards at the full {full_rows} rows "
              f"{s_full / ROUNDS:.4f} s/round, equal partitions {pf} and leaves, bank "
              f"{'bit-equal' if not diff else f'max |diff| {gap:.3e} at {len(diff)} keys'}; "
              f"{MAIN_SHARDS} shards at the automatic {pa.shard_width} rows "
              f"{s_auto / ROUNDS:.4f} s/round, dropped rows {pa.dropped_rows}, partitions "
              f"{bank_digest(auto)[0]}, acc_mean {hist_a[-1]['acc_mean']:.4f} (one device "
              f"{hist[-1]['acc_mean']:.4f})", flush=True)
        out["main"] = dict(s_round=s1 / ROUNDS, s_round_full=s_full / ROUNDS,
                           s_round_auto=s_auto / ROUNDS, dropped=pa.dropped_rows,
                           bit_equal=not diff)
        del base, full, auto
        secs["15b"] = time.perf_counter() - t15

        # ------------------------------------------- 15c: elastic runs
        t15 = time.perf_counter()
        epop = make_population(**ELASTIC_POP)
        cycles = {}
        for overlap in (0, 1):
            with counts(f"15c uninterrupted overlap {overlap}"):
                a, wall_a = uninterrupted_run(torch, epop, overlap)
            with counts(f"15c preempted overlap {overlap}"):
                b, saves, loads, wall_b = preempted_run(torch, epop, overlap, tmp)
            diff = digest_gap(run_digest(torch, a, ELASTIC_ROUNDS - 1),
                              run_digest(torch, b, ELASTIC_ROUNDS - 1))[0]
            if diff:
                raise AssertionError(f"15c overlap {overlap}: restored run differs at {diff}")
            cycles[overlap] = dict(save_s=statistics.mean(saves), load_s=statistics.mean(loads),
                                   overhead=(wall_b - wall_a) / wall_a, n=len(saves))
            print(f"[placement] 15c elastic, overlap {overlap}: {ELASTIC_ROUNDS} rounds with a "
                  f"save/load every {ELASTIC_EVERY} ({len(saves)} cycles) bit-equal to the "
                  f"uninterrupted run (bank, tables, fingerprints, evaluation); save "
                  f"{1e3 * cycles[overlap]['save_s']:.1f} ms, load "
                  f"{1e3 * cycles[overlap]['load_s']:.1f} ms a cycle; wall {wall_b:.3f} s vs "
                  f"{wall_a:.3f} s = overhead {100 * cycles[overlap]['overhead']:+.1f}%; partitions "
                  f"{[(e.parent, e.round_idx) for e in a.coordinator.partitions]}", flush=True)
        out["elastic"] = cycles
        # remesh: saved at 2 shards, restored onto 4 and onto 1
        with counts("15c remesh"):
            cont = {s: continuous(epop, REMESH_K, REMESH_R, s) for s in (4, 0)}
            eng = elastic_engine(epop, REMESH_R, 0, 2)
            for r in range(REMESH_K):
                eng.step(r)
            d = os.path.join(tmp, "remesh")
            save_run(d, eng)
            moved = {s: resumed(load_run(d, cohort_shards=s, device="cuda",
                                         devices=["cuda:0"] * s if s > 1 else None), REMESH_R)
                     for s in (4, 1)}
        remesh = {}
        for s, key in ((4, 4), (1, 0)):
            if moved[s].pipeline.bank.n_shards != s:
                raise AssertionError(f"15c remesh: {moved[s].pipeline.bank.n_shards} shards")
            diff, gap, bad = digest_gap(run_digest(torch, cont[key], REMESH_R - 1),
                                        run_digest(torch, moved[s], REMESH_R - 1))
            if bad:
                raise AssertionError(f"15c remesh 2->{s}: discrete state differs at {bad}")
            gap = max(gap, params_close(torch, cont[key], moved[s], 1e-4, 1e-5))
            remesh[s] = dict(bit_equal=not diff, gap=gap)
            print(f"[placement] 15c remesh 2->{s} (saved after round {REMESH_K}, {REMESH_R} "
                  f"rounds): {'bit-equal' if not diff else f'differs at {len(diff)} keys, params max |diff| {gap:.3e}'}"
                  f" against the run that lived at {s} shard(s); partitions "
                  f"{[(e.parent, e.round_idx) for e in moved[s].coordinator.partitions]}", flush=True)
        out["remesh"] = remesh
        del cont, moved
        # a checkpoint of a CPU run restored onto the card
        with counts("15c CPU -> card"):
            cpu = elastic_engine(epop, CROSS_R, 0, 0, device="cpu")
            for r in range(CROSS_K):
                cpu.step(r)
            d = os.path.join(tmp, "cpu")
            save_run(d, cpu)
            card = resumed(load_run(d, device="cuda"), CROSS_R)
            resumed(cpu, CROSS_R)
        if (bank_digest(cpu)[0] != bank_digest(card)[0]
                or cpu.coordinator.tree.leaves() != card.coordinator.tree.leaves()
                or not (cpu.pipeline.table.cluster_idx == card.pipeline.table.cluster_idx).all()):
            raise AssertionError("15c CPU -> card: partitions, leaves or assignments differ")
        gap = params_close(torch, cpu, card, 1e-4, 1e-5)
        print(f"[placement] 15c CPU checkpoint after round {CROSS_K} restored onto the card and "
              f"run to round {CROSS_R}: equal partitions {bank_digest(card)[0]}, leaves and "
              f"assignments; params vs the CPU's own continuation max |diff| {gap:.3e} "
              f"(rtol 1e-4, atol 1e-5)", flush=True)
        out["cpu_to_card"] = gap
        out["layout"] = layout_free_sums(torch, ops, ref)
        print(f"[placement] 15c one segment's 25 rows at {len(LAYOUT_PLACES)} placements (offsets "
              f"0 and 37, blocks 1 and 3, straddling rows 256, 512 and 1024): every call bit-equal "
              f"to the plain version on a CPU copy, the segment's sum the same bits everywhere, "
              f"placements by case {out['layout']}", flush=True)
        secs["15c"] = time.perf_counter() - t15
    finally:
        for u in undo:
            u()
        shutil.rmtree(tmp, ignore_errors=True)
    counts.check()
    t0 = time.perf_counter()
    worst = check_rows(torch, ops, ref, list(shapes["cosine_similarity"]),
                       list(shapes["segment_aggregate"]))
    secs["checks"] = time.perf_counter() - t0
    print(f"[placement] launches by path {counts.by_path}", flush=True)
    print(f"[placement] {len(shapes['cosine_similarity'])} cosine and "
          f"{len(shapes['segment_aggregate'])} segment call shapes of phase 15 held against the "
          f"plain version: max |err| {worst}; segment shapes {sorted(shapes['segment_aggregate'], key=repr)}",
          flush=True)
    print(f"[placement] seconds {({k: round(v, 2) for k, v in secs.items()})}, phase 15 "
          f"{sum(secs.values()):.2f} s", flush=True)
    total = {k: sum(n[k] for n in counts.by_path.values()) for k in ROUND_KERNELS}
    return dict(out, launches=total, by_path=counts.by_path, worst=worst, secs=secs)


# ------------------------------------------- phase 16: the launch plan
PLAN_GATE = 0.9  # a plan may not fall more than 10% below the measured peak
PLAN_CARD_BYTES = 1 << 20  # what the plans may allocate on the card: small constants only


def launch_steps(torch) -> dict:
    """``--launch`` alone: the peaks of the two steps phase 16 plans,
    measured as phases 10b and 13b measure them (the peak since before the
    params were drawn): granite-3-2b's federated round (one, of phase 10b's
    three) and qwen3-moe-235b-a22b's central step at depth 1 (one of 13b's
    three)."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    out = {}
    for name, arch, n_layers in (("10b", GRANITE, None), ("13b", QWEN3_MOE, 1)):
        cfg = get_config(arch)
        model = build_model(cfg if n_layers is None else cfg.replace(n_layers=n_layers))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(rnd.key(0), device="cuda")
        opt = steps.yogi_init(params)
        clust = steps.clustering_init(2, 128, device="cuda")
        if name == "10b":
            step = steps.make_train_step(model, steps.StepConfig(local_steps=2, d_sketch=128))
            toks = synth_corpus(LM_C, LM_M, LM_S, model.cfg.vocab)[0]
        else:
            step = steps.make_central_train_step(model, steps.StepConfig(d_sketch=128), n_clients=FAM_B)
            toks = synth_corpus(FAM_B, 1, FAM_S, model.cfg.vocab)[0].reshape(FAM_B, FAM_S)
        params, opt, clust, met = step(params, opt, clust, {"tokens": torch.from_numpy(toks).cuda()})
        if not math.isfinite(float(met["loss"])):
            raise AssertionError(f"16 {name}: non-finite loss")
        out[name] = torch.cuda.max_memory_allocated() / 1e9
        del params, opt, clust, step, met
    gc.collect()
    torch.cuda.empty_cache()
    return out


def launch_phase(torch, card, measured: dict) -> dict:
    """Phase 16: the dry run's plan (``launch.dryrun.plan_step``: the fake
    process group, a (1, 1) mesh, fake CUDA tensors, nothing allocated on
    the card) of phase 10b's granite-3-2b round and phase 13b's qwen3-moe
    central step at depth 1, beside the peaks ``measured`` on the card (GB).
    Fails if a plan is more than 10% below its measured peak."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.specs import SDS

    t_phase = time.perf_counter()
    lmesh.init_fake_world(1)
    try:
        mesh = lmesh.make_mesh((1, 1), ("data", "model"), "cuda")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        cases = {
            "10b": (get_config(GRANITE), {"tokens": SDS((LM_C, LM_M, LM_S), torch.int32)}, "tp",
                    steps.StepConfig(local_steps=2, d_sketch=128), LM_C),
            "13b": (get_config(QWEN3_MOE).replace(n_layers=1), {"tokens": SDS((FAM_B, FAM_S), torch.int32)},
                    "fsdp", steps.StepConfig(d_sketch=128), FAM_B),
        }
        plans = {}
        for name, (cfg, batch, policy, sc, n_clients) in cases.items():
            plans[name] = dryrun.plan_step(cfg, "train", batch, mesh, policy, sc, n_clients=n_clients)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - before  # what was freed meanwhile cannot hide it
    finally:
        dist.destroy_process_group()
    # the only real tensors are the constants that torch.tensor(data) makes
    # on the card before the fake mode wraps them (a PRNG key: one block)
    if grew > PLAN_CARD_BYTES:
        raise AssertionError(f"16: the plans allocated {grew} bytes on the card")
    print(f"[launch] 16 the plans' peak allocation on the card: {grew} bytes (the fake mode's "
          f"constants)", flush=True)
    out = {}
    for name, p in plans.items():
        gb = p["plan_bytes"] / 1e9
        ratio = gb / measured[name]
        out[name] = dict(plan_gb=gb, measured_gb=measured[name], ratio=ratio)
        print(f"[launch] 16 {name} {p['step']} plan on a (1, 1) mesh: state {p['state_bytes'] / 1e9:.3f} GB "
              f"{({k: round(v / 1e9, 3) for k, v in p['state_by_part'].items()})} + inputs "
              f"{p['input_bytes'] / 1e9:.6f} GB + step peak {p['step_peak_bytes'] / 1e9:.3f} GB (probes "
              f"{[round(b / 1e9, 3) for b in p['probes']['step_peak_bytes']]} GB at {p['probes']['units']} units, "
              f"{p['probes']['n_units']:g} units, {p['probes']['seconds']:.1f} s) = {gb:.3f} GB; measured "
              f"on the card {measured[name]:.3f} GB ({card}): plan / measured {ratio:.4f}; FLOPs "
              f"{p['flops_probe'] / 1e12:.3f} T, bytes {p['roofline']['bytes_per_device'] / 1e12:.3f} TB, "
              f"compute {p['roofline']['compute_s']:.4f} s, memory {p['roofline']['memory_s']:.4f} s, "
              f"bottleneck {p['roofline']['bottleneck']}, collectives {p['probes']['n_collectives']} "
              f"recorded at {p['probes']['units']} units", flush=True)
        if any(p["probes"]["n_collectives"]):
            raise AssertionError(f"16 {name}: a (1, 1) plan recorded collectives")
        if ratio < PLAN_GATE:
            raise AssertionError(f"16 {name}: the plan {gb:.3f} GB is more than 10% below the measured "
                                 f"peak {measured[name]:.3f} GB")
    secs = time.perf_counter() - t_phase
    print(f"[launch] phase 16 took {secs:.1f} s", flush=True)
    out["seconds"] = secs
    out["plans"] = plans
    return out


# ------------------------------------------- phase 17: the SPMD probe
SPMD_UNITS = 2  # repeating units in 17a's profiles (the reference profiler's default)
SPMD_TOP = 20
SPMD_LAYERS = 8  # 17c's depth: full width, 8 of granite's 40 layers (the plan probes 1, 2 and 3)
SPMD_WORLD = (1, 4)  # 17c's (data, model) fake world; this process is rank 0


def spmd_profiles(torch) -> dict:
    """17a: the collective profile of granite-3-2b ``train_4k`` (tp) and
    qwen3-moe-235b-a22b ``train_4k`` (fsdp) on the 16 x 16 fake mesh."""
    import torch.distributed as dist

    from repro_torch.launch import profile

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = {}
    try:
        for arch in (GRANITE, QWEN3_MOE):
            rep = profile.profile(arch, "train_4k", units=SPMD_UNITS, top=SPMD_TOP)
            if rep["by_op"]["total_weighted"] <= 0:
                raise AssertionError(f"17a {arch}: no collective recorded on 16 x 16")
            print(f"[spmd] 17a {arch} train_4k ({SPMD_UNITS} units, {rep['policy']}, 16x16 fake mesh, "
                  f"{len(rep['records'])} collectives, {rep['seconds']:.1f} s): per-card GB by op "
                  f"{({k: round(v / 1e9, 4) for k, v in rep['by_op'].items()})}", flush=True)
            for tot, cnt, b, op, sh in rep["top"]:
                print(f"[spmd] 17a   {tot / 1e9:8.3f} GB  x{cnt:<4d} {b / 1e6:9.2f} MB  {op:16s} {sh}")
            out[arch] = {"by_op": rep["by_op"], "n": len(rep["records"]), "seconds": rep["seconds"],
                         "step_peak_bytes": rep["step_peak_bytes"]}
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - before
    finally:
        dist.destroy_process_group()
    if grew > PLAN_CARD_BYTES:
        raise AssertionError(f"17a: the profiles allocated {grew} bytes on the card")
    print(f"[spmd] 17a the profiles' peak allocation on the card: {grew} bytes", flush=True)
    return out


def checked_segments(torch, ops, ref, log: list, tag: str, limit=None, seconds: list = None):
    """Wrap ``ops.segment_aggregate``: each call on plain CUDA tensors (a
    card's local shards), or the first ``limit`` of them, is held bit-equal
    to the plain version on a CPU copy (NaNs, which a fake group's unfilled
    buffers may feed in, must sit at the same places) and logged. With
    ``seconds``, each check's host seconds are appended to it (the card's
    queued work is waited for first and not counted). Returns the undo."""
    from repro_torch.utils import spmd

    orig = ops.segment_aggregate

    def seg(data, ids, k, weights=None):
        out = orig(data, ids, k, weights)
        if spmd.any_dtensor(data, ids, weights) or data.device.type != "cuda" or len(log) == limit:
            return out
        if seconds is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        want = ref.segment_aggregate(data.cpu(), ids.cpu(), k, None if weights is None else weights.cpu())
        got = out.cpu()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):  # equal bits, NaNs included
            nan = torch.isnan(want)
            if not (torch.equal(nan, torch.isnan(got))
                    and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))):
                raise AssertionError(f"{tag}: a segment call {tuple(data.shape)} K {k} is not the plain "
                                     "version's bits")
        log.append((tuple(data.shape), int(k), data.dtype))
        if seconds is not None:
            seconds.append(time.perf_counter() - t0)
        return out

    ops.segment_aggregate = seg
    return lambda: setattr(ops, "segment_aggregate", orig)


def spmd_round(torch, card, ops, ref, cs, sa) -> dict:
    """17c: phase 10b's granite-3-2b round at full width (``SPMD_LAYERS``
    layers) under tp as rank 0 of a (1, 4) fake world, real local shards on
    the card, against the SPMD plan and the fake-tensor probe of the same
    step."""
    import collections

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, local, steps
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import SDS
    from repro_torch.models import build_model
    from repro_torch.utils import hlo, spmd
    from repro_torch.utils.tree import leaves, tree_map

    cfg = get_config(GRANITE).replace(n_layers=SPMD_LAYERS)
    model = build_model(cfg)
    sc = steps.StepConfig(local_steps=2, d_sketch=128)
    spec = {"tokens": SDS((LM_C, LM_M, LM_S), torch.int32)}
    lmesh.init_fake_world(SPMD_WORLD[0] * SPMD_WORLD[1])
    seg_log = []
    try:
        mesh = lmesh.make_mesh(SPMD_WORLD, ("data", "model"), "cuda")
        t0 = time.perf_counter()
        plan = dryrun.plan_step(cfg, "train", spec, mesh, "tp", sc, n_clients=LM_C)
        fake = dryrun.probe_step(cfg, "train", spec, sc, mesh=mesh, policy="tp")
        plan_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        full = model.init(rnd.key(0), device="cuda")
        params = tree_map(lambda a, p: spmd.place(a, mesh, p), full,
                          shd.param_shardings(full, mesh, "tp"))
        del full
        gc.collect()
        torch.cuda.empty_cache()
        # Yogi's m and v under fsdp and the replicated clustering state, at local shape
        opt, clust = local.train_state(params, mesh, 2, 128, device="cuda")
        toks = torch.from_numpy(synth_corpus(LM_C, LM_M, LM_S, cfg.vocab)[0]).cuda()
        batch = {"tokens": spmd.place(toks, mesh, shd.batch_shardings({"tokens": toks}, mesh)["tokens"])}
        step = steps.make_train_step(model, sc)
        undo = checked_segments(torch, ops, ref, seg_log, "17c")
        sa.launches = cs.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            # the step counted as the probe counts it, here on the real tensors
            with implicit_replication():
                real = hlo.count_step(lambda: step(params, opt, clust, batch),
                                      leaves({"p": params, "o": opt, "c": clust, "b": batch}))
            torch.cuda.synchronize()
        finally:
            undo()
        step_s = time.perf_counter() - t0
        launches = {"cosine_similarity": cs.launches, "segment_aggregate": sa.launches}
        measured = (torch.cuda.max_memory_allocated() - base) / 1e9
        del params, opt, clust, batch, step
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    plan_gb = plan["plan_bytes"] / 1e9
    ratio = plan_gb / measured
    records = real.collectives
    real_counted = real.peak_bytes / 1e9
    real, probe = collections.Counter(records), collections.Counter(fake.collectives)
    print(f"[spmd] 17c {GRANITE} full width, {SPMD_LAYERS} layers, tp, rank 0 of a {SPMD_WORLD} fake world, "
          f"real local shards: round {step_s:.2f} s (the fake group moves no data: the loss is not held); "
          f"plan {plan_gb:.3f} GB (state {plan['state_bytes'] / 1e9:.3f} + inputs {plan['input_bytes'] / 1e9:.6f} "
          f"+ step peak {plan['step_peak_bytes'] / 1e9:.3f}; planned in {plan_s:.1f} s) vs measured "
          f"{measured:.3f} GB ({card}): plan / measured {ratio:.4f}; the probe's counter on the real "
          f"tensors {real_counted:.3f} GB (state included)", flush=True)
    print(f"[spmd] 17c collectives: real run {sum(real.values())}, fake-tensor probe {sum(probe.values())}, "
          f"equal {real == probe}; per-card GB by op {({k: round(v / 1e9, 4) for k, v in hlo.collective_bytes(records).items()})}",
          flush=True)
    print(f"[spmd] 17c kernel launches {launches} on local shards; {len(seg_log)} segment calls, each "
          f"bit-equal to the plain version on a CPU copy: {sorted(set(seg_log), key=repr)}", flush=True)
    if ratio < PLAN_GATE:
        raise AssertionError(f"17c: the plan {plan_gb:.3f} GB is more than 10% below the measured peak "
                             f"{measured:.3f} GB")
    if real != probe:
        raise AssertionError(f"17c: the real run's collectives differ from the probe's: "
                             f"{sorted((real - probe).items(), key=repr)[:5]} / {sorted((probe - real).items(), key=repr)[:5]}")
    if launches["segment_aggregate"] <= 0 or launches["segment_aggregate"] != len(seg_log):
        raise AssertionError(f"17c: {launches['segment_aggregate']} segment launches, {len(seg_log)} checked calls")
    if launches["cosine_similarity"]:
        raise AssertionError(f"17c: {launches['cosine_similarity']} cosine launches, none checked")
    return {"plan_gb": plan_gb, "measured_gb": measured, "ratio": ratio, "collectives": sum(real.values()),
            "launches": launches, "step_s": step_s, "counted_real_gb": real_counted}


def spmd_phase(torch, card, plans16, ops, ref, cs, sa) -> dict:
    """Phase 17: 17a the profiles, 17b phase 16's plans recorded no
    collective on (1, 1), 17c the round on real local shards."""
    t0 = time.perf_counter()
    prof = spmd_profiles(torch)
    for name, p in plans16.items():
        if any(p["probes"]["n_collectives"]) or p["roofline"]["coll_bytes_per_device"] != 0:
            raise AssertionError(f"17b: phase 16's {name} plan on (1, 1) recorded collectives")
    print(f"[spmd] 17b phase 16's plans on (1, 1): collectives "
          f"{({k: p['probes']['n_collectives'] for k, p in plans16.items()})} (0 in every probe)", flush=True)
    rnd_ = spmd_round(torch, card, ops, ref, cs, sa)
    secs = time.perf_counter() - t0
    print(f"[spmd] phase 17 took {secs:.1f} s", flush=True)
    return {"profiles": prof, "round": rnd_, "seconds": secs, "launches": rnd_["launches"]}


# ------------------------------- phase 18: llama4-maverick at full width
MAVERICK = "llama4-maverick-400b-a17b"
MAV_LAYERS = 8  # 18c's default depth: 4 of 24 dense/MoE pairs (the plan probes 1, 2 and 3 pairs)
MAV_FULL = 48  # ``--maverick``: the whole depth
MAV_MESH = (16, 16)  # the reference's production (data, model) mesh, ``fsdp`` (dryrun.FSDP_ARCHS)
MAV_RANKS = ((0, 15), (0, 0))  # 18b's mesh coordinates: the last model rank, then rank 0 (18c's)
MAV_LEAF = (128, 5120, 8192)  # one MoE layer's ``moe/wg``: 5,368,709,120 values, 21.47 GB in float32
MAV_LEAF_SLACK = 1e9  # 18a: what the draw may allocate besides its output
# card vs CPU: the draws' bits are equal, but torch's erfinv is CUDA's
# erfinvf on the card and its own on the CPU, which differ by up to 2 ulp on
# one uniform (on an H100: 1,471,250 of 4,194,304 values), up to 4 after
# the sqrt(2) and scale products; a value may differ by this many ulp
ERFINV_ULP = 8


def mav_cfg(layers: int):
    """llama4-maverick-400b-a17b as the dry run plans ``train_4k``: bf16."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.specs import effective_config

    return effective_config(get_config(MAVERICK), SHAPES["train_4k"]).replace(dtype=torch.bfloat16,
                                                                               n_layers=layers)


def bit_gap(torch, got, want) -> tuple:
    """(elements whose bits differ, the largest distance in units in the
    last place) of two float tensors of one dtype on the CPU."""
    iv = torch.int16 if got.element_size() == 2 else torch.int32
    a, b = got.reshape(-1).view(iv).long(), want.reshape(-1).view(iv).long()
    d = (a - b).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


def mav_leaf(torch) -> dict:
    """18a: one MoE layer's ``moe/wg`` drawn whole on the card by
    ``dense_init`` (a chunk at a time), its allocation beyond the output
    bounded; rows of experts 0, 102 (where the counters' high word turns
    1), 103 and 127 held against the same rows drawn alone (``rnd.Shard``):
    on the card bit-equal, on a CPU copy of the key bit-equal in their
    threefry bits and within ``ERFINV_ULP`` in value."""
    from repro_torch import random as rnd
    from repro_torch.models.common import deferred_draws, dense_init

    # the key model_init draws layer 0's moe/wg from: split(key, 3)[1] (the
    # backbone), split(., 8)[1] (moe_blocks), split(., n)[0] (layer 0: a
    # layer's key does not depend on n), split(., 2)[1] (the MoE), split(., 5)[1] (wg)
    k = rnd.key(0)
    for num, i in ((3, 1), (8, 1), (1, 0), (2, 1), (5, 1)):
        k = rnd.split(k, num)[i]
    E, D, F = MAV_LEAF
    row = 2**32 // F  # global row whose first counter is 2**32
    rows = [(0, 0, 1), (0, D - 1, 1), (row // D, row % D - 1, 2), (103, 0, 1), (127, 0, 1), (127, D - 1, 1)]
    shards = [rnd.Shard((1, n, F), (e, r, 0)) for e, r, n in rows]
    with deferred_draws():  # the leaf not drawn: its rows drawn alone (``Draw.fill``)
        draw = dense_init(k, MAV_LEAF, torch.float32)

    def alone(s, dev):
        return draw.fill(torch.empty(s.local_shape, dtype=torch.float32, device=dev), s)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    leaf = dense_init(k.cuda(), MAV_LEAF, torch.float32)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = torch.cuda.max_memory_allocated() - before
    out_bytes = leaf.numel() * leaf.element_size()
    card_eq = bits_eq = True
    cpu_gap, n = [0, 0], 0
    for s in shards:
        got = leaf[s.slices()].cpu()
        mine, cpu = alone(s, "cuda").cpu(), alone(s, "cpu")
        card_eq &= torch.equal(got.view(torch.int32), mine.view(torch.int32))
        bits_eq &= torch.equal(rnd.bits(k.cuda(), MAV_LEAF, shard=s).cpu(), rnd.bits(k, MAV_LEAF, shard=s))
        diff, ulp = bit_gap(torch, got, cpu)
        cpu_gap = [cpu_gap[0] + diff, max(cpu_gap[1], ulp)]
        n += got.numel()
    finite = bool(torch.isfinite(leaf).all())
    del leaf
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": secs, "grew_gb": grew / 1e9, "out_gb": out_bytes / 1e9, "extra_gb": (grew - out_bytes) / 1e9,
            "rows": rows, "n_sampled": n, "card_alone_equal": card_eq, "cpu_bits_equal": bits_eq,
            "cpu_differ": cpu_gap[0], "cpu_max_ulp": cpu_gap[1], "finite": finite}


def mav_sample_shards(cfg, shards, which: str):
    """Each leaf's first or last row (along the last dim) of the card's
    block, its layer axes whole: a tree of ``rnd.Shard`` over the leaves and
    the matching slices of the card's local tensors."""
    from repro_torch import random as rnd
    from repro_torch.models import transformer
    from repro_torch.utils.tree import tree_map_with_path

    stacks = transformer.block_stacks(cfg)

    def one(path, s):
        n = next((len(d) for name, d in stacks.items() if path.startswith(f"['backbone']['{name}']")), 0)
        nd = len(s.local_shape)
        pick = [0 if which == "first" else s.local_shape[d] - 1 for d in range(n, nd - 1)]
        sub = rnd.Shard(tuple(s.local_shape[:n]) + (1,) * (nd - n - 1) + (s.local_shape[-1],),
                        tuple(s.offsets[:n]) + tuple(o + p for o, p in zip(s.offsets[n:nd - 1], pick))
                        + (s.offsets[-1],))
        local = (slice(None),) * n + tuple(slice(p, p + 1) for p in pick) + (slice(None),)
        return sub, local

    pairs = tree_map_with_path(one, shards)
    return tree_map_with_path(lambda p, t: t[0], pairs), tree_map_with_path(lambda p, t: t[1], pairs)


def mav_check_rows(torch, model, shards, params) -> dict:
    """Every leaf's first and last block rows on the card against the same
    rows drawn alone (``Model.init_local`` of those rows): on the card
    (bit-equal) and on the CPU (within ``ERFINV_ULP``)."""
    from repro_torch import random as rnd
    from repro_torch.utils.tree import leaves

    card_eq, diff, ulp, n = True, 0, 0, 0
    for which in ("first", "last"):
        subs, local = mav_sample_shards(model.cfg, shards, which)
        alone = model.init_local(rnd.key(0), subs, device="cuda")
        cpu = model.init_local(rnd.key(0), subs, device="cpu")
        for a, sl, c, b in zip(leaves(params), leaves(local), leaves(alone), leaves(cpu)):
            got = a[sl].cpu()
            card_eq &= bit_gap(torch, got, c.cpu())[0] == 0
            d, u = bit_gap(torch, got, b)
            diff, ulp, n = diff + d, max(ulp, u), n + b.numel()
    return {"n_sampled": n, "card_alone_equal": card_eq, "cpu_differ": diff, "cpu_max_ulp": ulp}


def mav_step(torch, card, ops, ref, cs, sa, layers: int) -> dict:
    """18b and 18c: ranks (0, 15) and (0, 0) of the 16 x 16 mesh under
    ``fsdp`` initialised shard-locally on the card and held against the
    CPU; then ``train_4k``'s central step (``central_train``, the card's
    (16, 4096) batch) as rank 0 of a 256-rank fake world on rank 0's real
    local shards at full width, against the SPMD plan and the fake-tensor
    probe of the same step."""
    import collections

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as rnd
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, local, steps
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import TRAIN_CLIENTS, flat_batch_specs
    from repro_torch.models import build_model
    from repro_torch.utils import hlo, spmd
    from repro_torch.utils.tree import leaves, tree_map

    cfg = mav_cfg(layers)
    model = build_model(cfg)
    sc = steps.StepConfig()
    spec = flat_batch_specs(cfg, SHAPES["train_4k"])
    shapes = model.init_shapes()
    lmesh.init_fake_world(MAV_MESH[0] * MAV_MESH[1])
    seg_log = []
    ranks = {}
    try:
        mesh = lmesh.make_production_mesh(device_type="cuda")
        t0 = time.perf_counter()
        plan = dryrun.plan_step(cfg, "train", spec, mesh, "fsdp", sc)
        fake = dryrun.probe_step(cfg, "train", spec, sc, central=True, n_clients=TRAIN_CLIENTS, mesh=mesh,
                                 policy="fsdp")
        plan_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        for coords in MAV_RANKS:  # 18b
            params = mine = None  # the last rank's blocks go before the next rank's are drawn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = local.init_params(model, rnd.key(0), mesh, "fsdp", coords=coords, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            mine = tree_map(lambda a: a.to_local(), params)
            nbytes = sum(a.numel() * a.element_size() for a in leaves(mine))
            shards = local.param_shards(shapes, mesh, "fsdp", coords)
            ranks[coords] = dict(seconds=secs, gb=nbytes / 1e9, **mav_check_rows(torch, model, shards, mine))
            r = ranks[coords]
            print(f"[maverick] 18b rank {coords} of {MAV_MESH} (fsdp), {layers} layers: its shards drawn "
                  f"alone on the card in {secs:.2f} s, {nbytes / 1e9:.3f} GB; {r['n_sampled']} sampled values "
                  f"(each leaf's first and last block row) drawn alone again on the card bit-equal "
                  f"{r['card_alone_equal']}; against the CPU {r['cpu_differ']} differ, max "
                  f"{r['cpu_max_ulp']} ulp (allowed {ERFINV_ULP})", flush=True)
        del mine  # rank (0, 0)'s blocks stay, as ``params``
        opt, clust = local.train_state(params, mesh, sc.cluster_k, sc.d_sketch, device="cuda")
        bpl = shd.batch_shardings(spec, mesh)["tokens"]
        bshape = spmd.block(spec["tokens"].shape, bpl, MAV_MESH, MAV_RANKS[-1]).local_shape
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(0, cfg.vocab, bshape, generator=g, dtype=torch.int32).cuda()
        batch = {"tokens": spmd.from_local(toks, mesh, bpl)}
        state_gb = sum(a.to_local().numel() * a.to_local().element_size()
                       for a in leaves({"p": params, "o": opt, "c": clust, "b": batch})) / 1e9
        step = steps.make_central_train_step(model, sc, n_clients=TRAIN_CLIENTS)
        undo = checked_segments(torch, ops, ref, seg_log, "18c")
        sa.launches = cs.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with implicit_replication():
                real = hlo.count_step(lambda: step(params, opt, clust, batch),
                                      leaves({"p": params, "o": opt, "c": clust, "b": batch}))
                torch.cuda.synchronize()
                step1_s = time.perf_counter() - t0
                measured = (torch.cuda.max_memory_allocated() - base) / 1e9
                # the second step timed alone, under the profiler for the busy share
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    _, _, _, met = step(params, opt, clust, batch)
                    torch.cuda.synchronize()
                    step_s = time.perf_counter() - t0
        finally:
            undo()
        launches = {"cosine_similarity": cs.launches, "segment_aggregate": sa.launches}
        evs = prof.key_averages()
        busy = sum(e.self_device_time_total for e in evs if e.device_type == DeviceType.CUDA) / 1e6
        table = evs.table(sort_by="self_device_time_total", row_limit=12)
        loss = float(met["loss"].to_local() if spmd.is_dtensor(met["loss"]) else met["loss"])
        del params, opt, clust, batch, step, met, prof, evs
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    plan_gb = plan["plan_bytes"] / 1e9
    ratio = plan_gb / measured
    records = real.collectives
    real_c, probe_c = collections.Counter(records), collections.Counter(fake.collectives)
    roof = plan["roofline"]
    print(f"[maverick] 18c {MAVERICK} train_4k central_train at full width, {layers} of {MAV_FULL} layers, fsdp, "
          f"rank 0 of a {MAV_MESH} fake world on its real local shards (the fake group moves no data: the "
          f"loss {loss} is not the model's): plan {plan_gb:.3f} GB (state {plan['state_bytes'] / 1e9:.3f} + "
          f"inputs {plan['input_bytes'] / 1e9:.6f} + step peak {plan['step_peak_bytes'] / 1e9:.3f}; planned in "
          f"{plan_s:.1f} s with the fake probe) vs measured {measured:.3f} GB ({card}): plan / measured "
          f"{ratio:.4f}; state on the card {state_gb:.3f} GB; the probe's counter on the real tensors "
          f"{real.peak_bytes / 1e9:.3f} GB", flush=True)
    print(f"[maverick] 18c step {step_s:.3f} s (the counted first step {step1_s:.3f} s); the plan's roofline "
          f"compute_s {roof['compute_s']:.4f}, memory_s {roof['memory_s']:.4f}, collective_s "
          f"{roof['collective_s']:.4f}; device busy {busy:.4f} s under the profiler = "
          f"{100 * busy / step_s:.2f}% of the step; its kernels by device time:\n{table}", flush=True)
    print(f"[maverick] 18c collectives: real run {sum(real_c.values())}, fake-tensor probe "
          f"{sum(probe_c.values())}, equal {real_c == probe_c}; per-card GB by op "
          f"{({k: round(v / 1e9, 4) for k, v in hlo.collective_bytes(records).items()})}", flush=True)
    print(f"[maverick] 18c kernel launches {launches} on local shards (two steps); {len(seg_log)} segment "
          f"calls, each bit-equal to the plain version on a CPU copy: {sorted(set(seg_log), key=repr)}", flush=True)
    if ratio < PLAN_GATE:
        raise AssertionError(f"18c: the plan {plan_gb:.3f} GB is more than 10% below the measured peak "
                             f"{measured:.3f} GB")
    if real_c != probe_c:
        raise AssertionError(f"18c: the real run's collectives differ from the probe's: "
                             f"{sorted((real_c - probe_c).items(), key=repr)[:5]} / "
                             f"{sorted((probe_c - real_c).items(), key=repr)[:5]}")
    if launches["segment_aggregate"] <= 0 or launches["segment_aggregate"] != len(seg_log):
        raise AssertionError(f"18c: {launches['segment_aggregate']} segment launches, {len(seg_log)} checked calls")
    if launches["cosine_similarity"]:
        raise AssertionError(f"18c: {launches['cosine_similarity']} cosine launches, none checked")
    return {"layers": layers, "plan_gb": plan_gb, "measured_gb": measured, "ratio": ratio,
            "state_gb": state_gb, "collectives": sum(real_c.values()), "launches": launches,
            "step_s": step_s, "step1_s": step1_s, "busy_s": busy, "busy_share": busy / step_s,
            "roofline": {k: roof[k] for k in ("compute_s", "memory_s", "collective_s")},
            "plan_s": plan_s, "ranks": {str(k): v for k, v in ranks.items()}}


def maverick_phase(torch, card, ops, ref, cs, sa, layers: int = MAV_LAYERS) -> dict:
    """Phase 18: 18a the expert leaf drawn whole, 18b two ranks' shards
    drawn alone, 18c the central step on rank 0's shards."""
    t0 = time.perf_counter()
    leaf = mav_leaf(torch)
    print(f"[maverick] 18a {MAVERICK} moe/wg {MAV_LEAF} float32 drawn whole on the card by dense_init in "
          f"{leaf['seconds']:.2f} s ({card}): max_memory_allocated grew {leaf['grew_gb']:.3f} GB = the output "
          f"{leaf['out_gb']:.3f} + {leaf['extra_gb']:.3f} GB; {leaf['n_sampled']} sampled values (rows "
          f"(expert, row, n) {leaf['rows']}, the counters 2**32 - 8192 .. 2**32 + 8191 among them): drawn "
          f"alone on the card bit-equal {leaf['card_alone_equal']}; against the CPU: threefry bits equal "
          f"{leaf['cpu_bits_equal']}, values {leaf['cpu_differ']} differ, max {leaf['cpu_max_ulp']} ulp "
          f"(allowed {ERFINV_ULP}: the devices' erfinv)", flush=True)
    if not (leaf["finite"] and leaf["card_alone_equal"] and leaf["cpu_bits_equal"]) or leaf["cpu_max_ulp"] > ERFINV_ULP:
        raise AssertionError(f"18a: {leaf}")
    if leaf["grew_gb"] * 1e9 > leaf["out_gb"] * 1e9 + MAV_LEAF_SLACK:
        raise AssertionError(f"18a: the draw took {leaf['extra_gb']:.3f} GB besides its output")
    out = mav_step(torch, card, ops, ref, cs, sa, layers)
    for coords, r in out["ranks"].items():
        if not r["card_alone_equal"] or r["cpu_max_ulp"] > ERFINV_ULP:
            raise AssertionError(f"18b: rank {coords}'s samples: {r}")
    secs = time.perf_counter() - t0
    print(f"[maverick] phase 18 took {secs:.1f} s", flush=True)
    return {"leaf": leaf, "step": out, "seconds": secs, "launches": out["launches"]}


def maverick_only(torch) -> int:
    """``--maverick``: build, then phase 18 with the step at the whole depth."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa

    card = smi()
    print(card)
    print(f"[build] {build.build()}")
    out = maverick_phase(torch, card, ops, ref, cs, sa, MAV_FULL)
    print(json.dumps({"maverick": out}, default=str))
    print(card)
    return 0




def spmd_only(torch) -> int:
    """``--spmd``: build, the two steps' peaks and phase 16, then phase 17."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa

    card = smi()
    print(card)
    print(f"[build] {build.build()}")
    measured = launch_steps(torch)
    print(f"[launch] measured peaks (GB, {card}): {measured}", flush=True)
    out16 = launch_phase(torch, card, measured)
    out = spmd_phase(torch, card, out16["plans"], ops, ref, cs, sa)
    print(json.dumps({"spmd": {"round": out["round"], "seconds": out["seconds"],
                               "profiles": {k: {"by_op": v["by_op"], "n": v["n"], "seconds": v["seconds"]}
                                            for k, v in out["profiles"].items()}}}))
    print(card)
    return 0


def launch_only(torch) -> int:
    """``--launch``: the two steps' peaks on the card, then phase 16."""
    card = smi()
    print(card)
    from repro_torch.kernels import build

    print(f"[build] {build.build()}")
    measured = launch_steps(torch)
    print(f"[launch] measured peaks (GB, {card}): {measured}", flush=True)
    out = launch_phase(torch, card, measured)
    print(json.dumps({"launch": {k: v for k, v in out.items() if k != "plans"}}))
    print(card)
    return 0


def placement_only(torch) -> int:
    """``--placement``: build, then phase 15 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa

    card = smi()
    print(card)
    so = build.build()
    print(f"[build] {so}")
    run_main(torch, 2)  # warm-up: the first run also pays the card's and the libraries' start
    out = placement_phase(torch, np, ops, ref, cs, sa)
    print(json.dumps({"placement_launches": out["by_path"], "max_abs_err": out["worst"],
                      "secs": out["secs"]}))
    print(card)
    return 0


# --------------------- phase 19: split decode, the train driver's ranks, the examples
SPLIT_LAYERS = 8  # 19a/19b's depth: full width, 8 of granite's 40 layers (the plan probes 1, 2 and 3)
SPLIT_STEPS = 4  # decode steps of 19a and 19b
SPLIT_CASES = (("19a", "long_500k", False), ("19b", "decode_32k", True))  # (phase, shape, --cache-seq-shard)
TRAIN_ARGS = ["--rounds", "3", "--checkpoint-every", "3"]  # 19c, at the driver's default widths
EXAMPLE_ARGS = {"port_quickstart": [], "port_robust_fl": [], "port_serve_cohorts": [],
                "port_train_lm_federated": ["--rounds", "30"]}
# 19d: the round kernels each example must launch (the serving example runs none)
EXAMPLE_KERNELS = {"port_quickstart": ROUND_KERNELS, "port_robust_fl": ROUND_KERNELS,
                   "port_serve_cohorts": (), "port_train_lm_federated": ("segment_aggregate",)}
# 19d: the segment calls held against the plain version, where not all: the LM example's first two
# rounds (13 calls a round, each summing 8 clients' deltas of a ~100M-param leaf set)
EXAMPLE_CHECKED = {"port_train_lm_federated": 26}


def split_decode(torch, card, shape_name: str, seq_shard: bool) -> dict:
    """19a / 19b: granite-3-2b's decode at ``shape_name`` (its dry-run
    variant, bf16) as rank 0 of the 16 x 16 fake world, on rank 0's real
    local shards: params under tp (drawn shard-locally), the cache placed
    by ``cache_shardings(seq_shard=)`` from an index near the shape's end;
    ``SPLIT_STEPS`` decode steps against the SPMD plan and the fake-tensor
    probe of one step."""
    import collections

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, local, steps
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import effective_config, input_specs
    from repro_torch.models import build_model
    from repro_torch.utils import hlo, spmd
    from repro_torch.utils.tree import leaves, tree_map

    shape = SHAPES[shape_name]
    cfg = effective_config(get_config(GRANITE), shape).replace(dtype=torch.bfloat16, n_layers=SPLIT_LAYERS)
    model = build_model(cfg)
    sc = steps.StepConfig()
    spec = input_specs(get_config(GRANITE), shape_name)
    B = spec["tokens"].shape[0]
    lmesh.init_fake_world(256)
    try:
        mesh = lmesh.make_production_mesh(device_type="cuda")
        t0 = time.perf_counter()
        plan = dryrun.plan_step(cfg, "decode", spec, mesh, "tp", sc, cache_len=shape.seq_len,
                                seq_shard_cache=seq_shard)
        fake = dryrun.probe_step(cfg, "decode", spec, sc, cache_len=shape.seq_len, mesh=mesh, policy="tp",
                                 seq_shard_cache=seq_shard)
        plan_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        (torch.ones(8, 8, device="cuda", dtype=torch.bfloat16)
         @ torch.ones(8, 8, device="cuda", dtype=torch.bfloat16)).sum().item()
        base = torch.cuda.memory_allocated()
        params = local.init_params(model, rnd.key(0), mesh, "tp", device="cuda")
        meta = model.init_cache(B, shape.seq_len, torch.bfloat16, device="meta")
        cpl = shd.cache_shardings(meta, B, mesh, seq_shard)
        index = shape.seq_len - SPLIT_STEPS  # the context's last positions: the ring has wrapped

        def shard(a, pl):
            local_shape = spmd.block(tuple(a.shape), pl, tuple(mesh.shape), (0,) * mesh.ndim).local_shape
            if a.dtype.is_floating_point:
                t = torch.randn(local_shape, device="cuda", dtype=torch.float32).to(a.dtype)
            else:
                t = torch.full(local_shape, index, device="cuda", dtype=a.dtype)
            return spmd.from_local(t, mesh, pl)

        cache = tree_map(shard, meta, cpl)
        toks = torch.from_numpy(synth_corpus(B, 1, 1, cfg.vocab)[0].reshape(B, 1)).cuda()
        batch = {"tokens": spmd.place(toks, mesh, shd.batch_shardings({"tokens": toks}, mesh)["tokens"])}
        step = steps.make_serve_step(model, sc)
        ring = tuple(cache["blocks"]["k"].shape)
        local_ring = tuple(cache["blocks"]["k"].to_local().shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        records, logits = [], None
        with implicit_replication():
            for _ in range(SPLIT_STEPS):
                def one():
                    nonlocal logits, cache
                    logits, cache = step(params, cache, batch)
                    return logits
                got = hlo.count_step(one, leaves({"p": params, "c": cache, "b": batch}))
                records.append(collections.Counter(got.collectives))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SPLIT_STEPS
        measured = (torch.cuda.max_memory_allocated() - base) / 1e9
        idx = cache["blocks"]["index"]
        idx = int((idx.to_local() if spmd.is_dtensor(idx) else idx).reshape(-1)[0])
        lshape = tuple(logits.to_local().shape)
        del params, cache, batch, logits
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    plan_gb = plan["plan_bytes"] / 1e9
    probe = collections.Counter(fake.collectives)
    return {"plan_gb": plan_gb, "measured_gb": measured, "ratio": plan_gb / measured,
            "state_gb": plan["state_bytes"] / 1e9, "cache_gb": plan["state_by_part"]["cache"] / 1e9,
            "step_peak_gb": plan["step_peak_bytes"] / 1e9, "plan_s": plan_s, "step_s": step_s,
            "collectives": [sum(r.values()) for r in records], "probe_collectives": sum(probe.values()),
            "equal": all(r == probe for r in records), "by_op": hlo.collective_bytes(fake.collectives),
            "roofline": plan["roofline"], "cache": ring, "local_cache": local_ring, "index": idx,
            "start": index, "logits": lshape, "diff": [sorted((r - probe).items(), key=repr)[:3] for r in records]}


def split_decode_phase(torch, card) -> dict:
    """19a and 19b."""
    out = {}
    for tag, shape_name, seq_shard in SPLIT_CASES:
        r = split_decode(torch, card, shape_name, seq_shard)
        r3 = r["roofline"]
        print(f"[drivers] {tag} {GRANITE} {shape_name}{' --cache-seq-shard' if seq_shard else ''} full width, "
              f"{SPLIT_LAYERS} layers, bf16, tp, rank 0 of the 16 x 16 fake world, real local shards: cache "
              f"{r['cache']} per layer stack, rank 0's {r['local_cache']}; index {r['start']} -> {r['index']} "
              f"after {SPLIT_STEPS} steps, {r['step_s'] * 1e3:.2f} ms a step (the fake group moves no data); "
              f"plan {r['plan_gb']:.4f} GB (state {r['state_gb']:.4f}, cache {r['cache_gb']:.4f}, step peak "
              f"{r['step_peak_gb']:.4f}; planned in {r['plan_s']:.1f} s) vs measured {r['measured_gb']:.4f} GB "
              f"({card}): plan / measured {r['ratio']:.4f}; roofline compute {r3['compute_s'] * 1e3:.4f} ms, "
              f"memory {r3['memory_s'] * 1e3:.4f} ms, collective {r3['collective_s'] * 1e3:.4f} ms", flush=True)
        print(f"[drivers] {tag} collectives per step: real run {r['collectives']}, fake-tensor probe "
              f"{r['probe_collectives']}, equal {r['equal']}; per-card GB by op (probe, {SPLIT_LAYERS} layers) "
              f"{({k: round(v / 1e9, 6) for k, v in r['by_op'].items()})}", flush=True)
        if r["ratio"] < PLAN_GATE:
            raise AssertionError(f"{tag}: the plan {r['plan_gb']:.4f} GB is more than 10% below the measured "
                                 f"peak {r['measured_gb']:.4f} GB")
        if not r["equal"]:
            raise AssertionError(f"{tag}: the real run's collectives differ from the probe's: {r['diff']}")
        if r["index"] != r["start"] + SPLIT_STEPS:
            raise AssertionError(f"{tag}: the cache index went {r['start']} -> {r['index']}")
        out[tag] = r
    return out


def ckpt_gap(np, a: str, b: str) -> dict:
    """The largest |difference| per checkpoint file of two ``launch.train``
    checkpoint directories, and whether they hold at the tests' tolerances
    (tests/test_torch_train_ranks.py: rtol 1e-4, atol 1e-5, counts equal,
    centroids at 1e-4)."""
    gaps, ok = {}, True
    for name in ("params", "opt", "clust"):
        x, y = np.load(os.path.join(a, f"{name}.npz")), np.load(os.path.join(b, f"{name}.npz"))
        ok &= sorted(x.files) == sorted(y.files)
        gaps[name] = 0.0
        for k in y.files:
            u, v = x[k].astype(np.float64), y[k].astype(np.float64)
            gaps[name] = max(gaps[name], float(np.abs(u - v).max()) if u.size else 0.0)
            if k == "['counts']":
                ok &= bool(np.array_equal(u, v))
            else:
                atol, rtol = (1e-4, 0.0) if k == "['centroids']" else (1e-5, 1e-4)
                ok &= bool(np.allclose(u, v, rtol=rtol, atol=atol))
    return {"max_abs": gaps, "ok": ok}


def train_rank(torch, argv) -> int:
    """``--train-rank FLAGS``: ``launch.train FLAGS`` as the rank that
    ``torch.distributed.run`` starts in 19c, every segment call held against
    the plain version; prints its launches, counted from 0, as the last line."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.launch import train

    build.build()
    log = []
    undo = checked_segments(torch, ops, ref, log, "19c")
    sa.launches = cs.launches = 0
    try:
        train.main(argv)
        torch.cuda.synchronize()
    finally:
        undo()
    print(json.dumps({"launches": {"cosine_similarity": cs.launches, "segment_aggregate": sa.launches},
                      "checked": len(log)}))
    return 0


def train_ranks(torch, np, ops, ref, card, cs, sa) -> dict:
    """19c: ``launch.train`` at its default widths under
    ``torch.distributed.run`` as a 1-rank NCCL group (which trains as a run
    alone does), its checkpoint against the one-device driver's from this
    process; in both runs every segment call is held against the plain
    version and the launches are counted from 0."""
    import io
    import tempfile

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        one, ranked = os.path.join(tmp, "one"), os.path.join(tmp, "ranked")
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("WORLD_SIZE", None)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                               "1", os.path.join(ROOT, "chip_smoke.py"), "--train-rank", *TRAIN_ARGS,
                               "--ckpt-dir", ranked],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              timeout=600)
        ranked_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"19c: the 1-rank NCCL group failed: {proc.stderr[-3000:]}")
        rank = json.loads(proc.stdout.strip().splitlines()[-1])
        log = []
        undo = checked_segments(torch, ops, ref, log, "19c")
        sa.launches = cs.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                train.main(TRAIN_ARGS + ["--ckpt-dir", one])
            torch.cuda.synchronize()
        finally:
            undo()
        one_s = time.perf_counter() - t0
        launches = {"cosine_similarity": cs.launches, "segment_aggregate": sa.launches}
        gap = ckpt_gap(np, ranked, one)
        files = {n: [np.load(os.path.join(d, f"{n}.npz")) for d in (ranked, one)] for n in ("params", "opt", "clust")}
        same = all(np.array_equal(a[k], b[k]) for a, b in files.values() for k in b.files)
    lines = [l for l in proc.stdout.splitlines() if l.startswith(("round", "placement"))]
    want = [l for l in buf.getvalue().splitlines() if l.startswith("round")]
    print(f"[drivers] 19c launch.train {' '.join(TRAIN_ARGS)} as a 1-rank NCCL group (torch.distributed.run "
          f"--standalone, {ranked_s:.1f} s with the process start) vs one device in this process ({one_s:.1f} s): "
          f"{lines}; one device {want}; checkpoints' max |diff| {gap['max_abs']}, bit-equal {same}, equal at the "
          f"tests' tolerances {gap['ok']}; launches: the rank's {rank['launches']} ({rank['checked']} segment calls "
          f"held against the plain version), the one-device driver's {launches} ({len(log)} held) ({card})",
          flush=True)
    if not gap["ok"]:
        raise AssertionError(f"19c: the 1-rank group's checkpoint differs from one device's: {gap}")
    if [l.split("(")[0] for l in lines if l.startswith("round")] != [l.split("(")[0] for l in want]:
        raise AssertionError("19c: the printed losses differ")
    for who, got, held in (("the rank", rank["launches"], rank["checked"]), ("one device", launches, len(log))):
        if got["segment_aggregate"] <= 0 or held != got["segment_aggregate"]:
            raise AssertionError(f"19c: {who}: {got} launches, {held} segment calls held")
    return {"ranked_s": ranked_s, "one_s": one_s, "gap": gap, "bit_equal": same, "launches": rank["launches"],
            "one_device_launches": launches}


def run_examples(torch, ops, ref, card, cs, sa) -> dict:
    """19d: the four ``examples/port_*.py`` on the card in this process,
    each one's round-kernel launches counted from 0 and its segment calls
    (or the first ``EXAMPLE_CHECKED`` of them) held against the plain
    version."""
    import io

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    out = {}
    for name, args in EXAMPLE_ARGS.items():
        mod = __import__(name)
        buf = io.StringIO()
        log = []
        undo = checked_segments(torch, ops, ref, log, f"19d {name}", EXAMPLE_CHECKED.get(name))
        sa.launches = cs.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = mod.main(args)
            torch.cuda.synchronize()
        finally:
            undo()
        secs = time.perf_counter() - t0
        launches = {"cosine_similarity": cs.launches, "segment_aggregate": sa.launches}
        last = [l for l in buf.getvalue().splitlines() if l.strip()][-3:]
        print(f"[drivers] 19d {name}.py {' '.join(args)} on the card in {secs:.1f} s, with {len(log)} segment "
              f"calls held against the plain version ({card}): kernel launches {launches}; last lines {last}",
              flush=True)
        for k in EXAMPLE_KERNELS[name]:
            if launches[k] <= 0:
                raise AssertionError(f"19d: {name} never launched {k}: {launches}")
        if len(log) != min(launches["segment_aggregate"], EXAMPLE_CHECKED.get(name, launches["segment_aggregate"])):
            raise AssertionError(f"19d: {name}: {len(log)} of {launches['segment_aggregate']} segment calls held")
        if name == "port_quickstart" and not (res["hist"][-1]["n_cohorts"] >= 2
                                              and res["hist"][-1]["acc_mean"] > res["base"][-1]["acc_mean"]):
            raise AssertionError(f"19d: {name}: {res['hist'][-1]} against the baseline {res['base'][-1]}")
        if name == "port_robust_fl" and not all(0.0 <= h[-1]["acc_mean"] <= 1.0 for _, h in res["runs"].values()):
            raise AssertionError(f"19d: {name}: an accuracy outside [0, 1]")
        if name == "port_serve_cohorts" and not all(int(t.min()) >= 0 and int(t.max()) < 1024 for t in res.values()):
            raise AssertionError(f"19d: {name}: a token outside the vocabulary")
        if name == "port_train_lm_federated" and not all(
                math.isfinite(h["loss"]) and sum(h["counts"]) == 8 for h in res):
            raise AssertionError(f"19d: {name}: {res[-1]}")
        out[name] = {"seconds": secs, "launches": launches, "last": last, "checked": len(log)}
    return out


def drivers_phase(torch, np, ops, ref, card, cs, sa) -> dict:
    """Phase 19: 19a/19b the split decodes, 19c the train driver as a
    1-rank group, 19d the examples."""
    t0 = time.perf_counter()
    split = split_decode_phase(torch, card)
    ranks = train_ranks(torch, np, ops, ref, card, cs, sa)
    ex = run_examples(torch, ops, ref, card, cs, sa)
    launches = {k: {name: e["launches"][k] for name, e in ex.items()} for k in ROUND_KERNELS}
    launches["segment_aggregate"]["launch.train"] = ranks["launches"]["segment_aggregate"]
    secs = time.perf_counter() - t0
    print(f"[drivers] phase 19 took {secs:.1f} s", flush=True)
    return {"split": split, "ranks": ranks, "examples": ex, "launches": launches, "seconds": secs}


def drivers_only(torch) -> int:
    """``--drivers``: build, then phase 19 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa

    card = smi()
    print(card)
    print(f"[build] {build.build()}")
    out = drivers_phase(torch, np, ops, ref, card, cs, sa)
    print(json.dumps({"drivers": out}, default=str))
    print(card)
    return 0


# ------------------------------------------ phase 20: the reference's last options
OPT_LAYERS = 8  # 20b's depth: full width, 8 of granite's 40 layers (the plan probes 1, 2 and 3)
BANK_MESH = (4, 2)  # 20a: cohort shards x model positions, all on card 0
BANK_CAP = 8
BANK_SPAWNS = [("0", ["1", "2"]), ("1", ["3", "4"]), ("2", ["5"]), ("4", ["6", "7"])]  # 7 spawns
SERVE_QUERIES = 64  # 20c


def tree_gap(torch, a, b) -> float:
    """The largest |a - b| over two trees' leaves."""
    from repro_torch.utils.tree import leaves

    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(leaves(a), leaves(b)))


def tree_equal(torch, a, b) -> bool:
    from repro_torch.utils.tree import leaves

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def bank_options(torch, card) -> dict:
    """20a: a ``tp`` bank of granite-3-2b at full width (depth 1 of 40),
    capacity 8, on ``make_cohort_mesh(4, model=2, devices=[cuda:0] * 8)``,
    beside a ``dp`` bank on the same mesh: 7 spawns in each, every slot's
    params and Yogi state bit-equal; the bytes a model position holds; the
    tp bank's params re-packed (4 x 2) -> (2 x 2) -> (1 x 1) into each
    target's pieces, bit-equal to the dp bank's own re-pack."""
    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.fl.pipeline import CohortBank
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_cohort_mesh
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves, tree_map

    t0 = time.perf_counter()
    model = build_model(get_config(GRANITE).replace(n_layers=1))
    params = model.init(rnd.key(0), device="cuda")
    opt = {"m": tree_map(torch.neg, params), "v": tree_map(torch.square, params)}
    slot_gb = sum(a.numel() * a.element_size() for a in leaves(params)) / 1e9
    n_leaves = len(leaves(params))
    n, m = BANK_MESH
    mesh = make_cohort_mesh(n, model=m, devices=[torch.device("cuda", 0)] * (n * m))
    tp = CohortBank(params, opt, BANK_CAP, mesh=mesh, policy="tp")
    dp = CohortBank(params, opt, BANK_CAP, mesh=mesh)
    del params, opt
    if not tp.sharded or tp.group_params is not None or dp.sharded:
        raise AssertionError("20a: the tp bank does not hold pieces, or the dp bank does")
    for parent, children in BANK_SPAWNS:
        if tp.spawn_children(parent, children) != dp.spawn_children(parent, children):
            raise AssertionError(f"20a: the banks put {children} in different slots")
    torch.cuda.synchronize()
    for cid in dp.slot_of:
        if not (tree_equal(torch, tp.params_of(cid), dp.params_of(cid))
                and tree_equal(torch, tp.opt_state_of(cid), dp.opt_state_of(cid))):
            raise AssertionError(f"20a: cohort {cid}'s slot differs between the tp and dp banks")
    pos_gb = [sum(p[k].numel() * p[k].element_size() for a in leaves(tp.placed_params) for p in a.parts)
              / 1e9 for k in range(m)]
    dp_gb = sum(a.numel() * a.element_size() for g in dp.group_params for a in leaves(g)) / 1e9
    split = sum(a.sharding.split_dim is not None for a in leaves(tp.placed_params))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # re-packs of the params: tp pieces into each target's pieces vs the dp bank's whole re-pack
    A, repacks = tp._next, []
    tree, want, old = tp.placed_params, dp.params, n
    for tn, tm in ((2, 2), (1, 1)):
        target = make_cohort_mesh(tn, model=tm, devices=[torch.device("cuda", 0)] * (tn * tm))
        sh = shd.bank_shardings(tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"), tree),
                                target, "tp")
        tree = shd.repack_stacked(tree, BANK_CAP, A, old, tn, out_shardings=sh)
        want = shd.repack_stacked(want, BANK_CAP, A, old, tn)
        placed = all(isinstance(a, shd.Placed) and len(a.parts[0]) == tm for a in leaves(tree))
        same = tree_equal(torch, tree_map(lambda a: a.whole(), tree), want)
        repacks.append((f"{tn}x{tm}", placed, same))
        if not (placed and same):
            raise AssertionError(f"20a: the re-pack to {tn} x {tm} is not in the target's pieces or not bit-equal")
        old = tn
    del tp, dp, tree, want
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[options] 20a {GRANITE} full width, depth 1 of 40: a slot {slot_gb:.3f} GB f32; capacity "
          f"{BANK_CAP} on make_cohort_mesh({n}, model={m}, devices=[cuda:0] x {n * m}); 7 spawns "
          f"{BANK_SPAWNS}: every slot's params and Yogi m, v bit-equal between the tp and dp banks; tp "
          f"params a model position {[round(g, 4) for g in pos_gb]} GB ({split} of {n_leaves} leaves "
          f"split) vs the dp bank's {dp_gb:.4f} GB a shard group; re-packs {repacks}; peak {peak_gb:.2f} GB; "
          f"{secs:.1f} s ({card})", flush=True)
    return dict(slot_gb=slot_gb, pos_gb=pos_gb, dp_gb=dp_gb, split=split, repacks=repacks, peak_gb=peak_gb,
                seconds=secs)


def lm_round(torch, ops, ref, cfg, params0, toks, seg_log: list) -> dict:
    """One federated round of ``cfg`` (phase 10b's step and corpus) from a
    copy of ``params0``, its segment calls held bit-equal to the plain
    version (``checked_segments``): the loss, counts, params, peak (above
    what lived before the round's state was made), wall and the wall less
    the checks' host time, and the segment launches counted from 0."""
    from repro_torch.launch import steps
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves, tree_map

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = tree_map(torch.clone, params0)
    opt = steps.yogi_init(params)
    clust = steps.clustering_init(2, 128, device="cuda")
    step = steps.make_train_step(build_model(cfg), steps.StepConfig(local_steps=2, d_sketch=128))
    check_s = []
    undo = checked_segments(torch, ops, ref, seg_log, "20b", seconds=check_s)
    sa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        params, opt, clust, met = step(params, opt, clust, {"tokens": toks})
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    loss = float(met["loss"])
    if not math.isfinite(loss) or not all(bool(torch.isfinite(a).all()) for a in leaves(params)):
        raise AssertionError(f"20b {cfg.remat_policy}: non-finite loss or params")
    return dict(loss=loss, counts=met["cluster_counts"].tolist(), params=params, wall=wall,
                secs=wall - sum(check_s), measured_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                launches=sa.launches)


def remat_rounds(torch, card, ops, ref, warm_up: bool) -> dict:
    """20b: granite-3-2b's LM round (phase 10b's path) at full width, depth
    8 of 40, one round under each remat policy from the same state, after
    a warm-up round at depth 1 where asked (``--options``: the process's
    first GEMMs of these shapes and first sketch draws; the whole script
    reaches phase 20 warm): the losses, the largest gap between the two
    rounds' params, s/round (the round's wall less its segment checks' host
    time, each check starting after the card's queued work), the peak
    against the dry run's plan on a (1, 1) mesh (gate 0.9), and every
    segment-kernel call of the three rounds held bit-equal to the plain
    version on a CPU copy, the launches counted from 0."""
    import torch.distributed as dist

    from repro_torch import random as rnd
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.specs import SDS
    from repro_torch.models import build_model

    sc = steps.StepConfig(local_steps=2, d_sketch=128)
    base_cfg = get_config(GRANITE).replace(n_layers=OPT_LAYERS)
    toks = torch.from_numpy(synth_corpus(LM_C, LM_M, LM_S, base_cfg.vocab)[0]).cuda()
    spec = {"tokens": SDS((LM_C, LM_M, LM_S), torch.int32)}
    seg_log, warm, launches = [], None, 0
    if warm_up:
        warm_cfg = base_cfg.replace(n_layers=1)
        warm = lm_round(torch, ops, ref, warm_cfg, build_model(warm_cfg).init(rnd.key(0), device="cuda"), toks,
                        seg_log)
        launches = warm.pop("launches")
        del warm["params"]
    params0 = build_model(base_cfg).init(rnd.key(0), device="cuda")
    out = {}
    for policy in ("full", "outputs"):
        out[policy] = lm_round(torch, ops, ref, base_cfg.replace(remat_policy=policy), params0, toks, seg_log)
        launches += out[policy].pop("launches")
    del params0
    gap = tree_gap(torch, out["full"].pop("params"), out["outputs"].pop("params"))
    gc.collect()
    torch.cuda.empty_cache()
    lmesh.init_fake_world(1)
    try:
        mesh = lmesh.make_mesh((1, 1), ("data", "model"), "cuda")
        for policy, o in out.items():
            t0 = time.perf_counter()
            plan = dryrun.plan_step(base_cfg.replace(remat_policy=policy), "train", spec, mesh, "tp", sc,
                                    n_clients=LM_C)
            o.update(plan_gb=plan["plan_bytes"] / 1e9, step_peak_gb=plan["step_peak_bytes"] / 1e9,
                     plan_s=time.perf_counter() - t0, probe_peaks=plan["probes"]["step_peak_bytes"])
            o["ratio"] = o["plan_gb"] / o["measured_gb"]
    finally:
        dist.destroy_process_group()
    for policy, o in out.items():
        print(f"[options] 20b {GRANITE} full width, {OPT_LAYERS} layers, remat {policy}: loss {o['loss']!r}, "
              f"counts {o['counts']}, {o['secs']:.3f} s/round ({o['wall']:.3f} s with the segment checks' "
              f"host time), peak {o['measured_gb']:.3f} GB vs plan "
              f"{o['plan_gb']:.3f} GB (step peak {o['step_peak_gb']:.3f}; probes "
              f"{[round(b / 1e9, 3) for b in o['probe_peaks']]} GB at 1, 2, 3 layers; planned in "
              f"{o['plan_s']:.1f} s): plan / measured {o['ratio']:.4f} ({card})", flush=True)
    print(f"[options] 20b losses equal as printed: {out['full']['loss'] == out['outputs']['loss']}; the "
          f"params' largest gap between the policies {gap:.3e}; "
          + (f"the depth-1 warm-up round {warm['wall']:.3f} s ({warm['secs']:.3f} s without its checks); "
             if warm else "") + f"{launches} segment launches in the phase's rounds, {len(seg_log)} calls each "
          "bit-equal to the plain version on a CPU copy", flush=True)
    if repr(out["full"]["loss"]) != repr(out["outputs"]["loss"]):
        raise AssertionError(f"20b: the losses differ: {out['full']['loss']!r} vs {out['outputs']['loss']!r}")
    if launches <= 0 or launches != len(seg_log):
        raise AssertionError(f"20b: {launches} segment launches, {len(seg_log)} checked calls")
    for policy, o in out.items():
        if o["ratio"] < PLAN_GATE:
            raise AssertionError(f"20b {policy}: the plan {o['plan_gb']:.3f} GB is more than 10% below the "
                                 f"measured peak {o['measured_gb']:.3f} GB")
    return dict(policies=out, gap=gap, warm_up=warm, launches=launches, checked=len(seg_log))


def bucket_serving(torch, np) -> dict:
    """20c: on phase 4's run, ``ServingPlane(bucket_min=1, max_batch=1)``
    answers 64 queries one at a time (64 inferences of width 1) the same as
    the batched plane (one inference, width 64)."""
    from repro_torch.serve import ServingPlane

    eng, _, _ = run_main(torch, ROUNDS)
    ids = np.arange(eng.data.n_clients, dtype=np.int64)
    hot = ids[np.asarray(eng.fp_seen[ids], bool)]
    cold = np.setdiff1d(ids, hot)
    queries = np.concatenate([hot[:SERVE_QUERIES // 2], cold[:SERVE_QUERIES // 2]])
    one, batched = ServingPlane(eng, max_batch=1, bucket_min=1), ServingPlane(eng)
    singles = np.concatenate([one.serve_batch(queries[i:i + 1]) for i in range(queries.size)])
    together = batched.serve_batch(queries)
    slots = sorted(set(batched.route_slots(queries).tolist()))
    print(f"[options] 20c {queries.size} queries ({hot[:SERVE_QUERIES // 2].size} hot) over slots {slots}: "
          f"bucket_min 1, max_batch 1: {one.infer_dispatches} inferences; batched (bucket_min 8): "
          f"{batched.infer_dispatches}; answers equal {bool(np.array_equal(singles, together))}", flush=True)
    if one.infer_dispatches != queries.size or batched.infer_dispatches != 1:
        raise AssertionError("20c: the planes made the wrong number of inferences")
    if not np.array_equal(singles, together):
        raise AssertionError(f"20c: the per-query plane answered {int((singles != together).sum())} queries "
                             "differently")
    return dict(queries=int(queries.size), slots=slots)


def options_phase(torch, np, ops, ref, card, warm_up: bool = False) -> dict:
    """Phase 20: 20a the tp bank on a model axis, 20b the remat policies on
    granite's round, 20c the per-query plane."""
    t0 = time.perf_counter()
    bank = bank_options(torch, card)
    remat = remat_rounds(torch, card, ops, ref, warm_up)
    serve = bucket_serving(torch, np)
    secs = time.perf_counter() - t0
    print(f"[options] phase 20 took {secs:.1f} s", flush=True)
    return dict(bank=bank, remat=remat, serve=serve, seconds=secs,
                launches={"cosine_similarity": 0, "segment_aggregate": remat["launches"]})


def options_only(torch) -> int:
    """``--options``: build, then phase 20 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref

    card = smi()
    print(card)
    print(f"[build] {build.build()}")
    out = options_phase(torch, np, ops, ref, card, warm_up=True)
    print(json.dumps({"options": {"bank": out["bank"], "remat": out["remat"], "seconds": out["seconds"]}}))
    print(card)
    return 0


# ------------------------------------------------- phase 21: the paper's drivers
# repro_torch.paper's drivers at a cut, each on its own full-size scenario:
# 16 rounds, one scenario each (Tables 3 and 4 on openimage-like), Figures
# 13 and 14 at each sweep's default and one other value; Table 5 at its own
# settings on femnist-like (80 rounds, k 4, and CFL's 100-client, 20-round
# scenario: phase 12c's run, moved here); then (b) Table 3 on a 120-client
# cut of openimage-like on the card and on the CPU
PAPER_ROUNDS = 16
PAPER_CUTS = {
    "fig13_sensitivity": dict(AFFINE_SHIFTS=(0.0, 1.0), PARTITION_STARTS=(0.08, 0.3), MAX_COHORTS=(4, 2),
                              CLUSTER_STARTS=(0.03, 0.15)),
    "fig14_resilience": dict(LDP_SIGMAS=(0.0, 0.6), CORRUPT_FRACS=(0.0, 0.1), AFFINITY_LOSS_RATES=(0.0, 0.1)),
    "table5_clustered_fl": dict(DATASETS=("femnist-like",)),
}
PAPER_SMALL_CLIENTS = 120  # 21b: tests/torch_paper_cases.py's cut at 120 clients, 12 rounds
PAPER_SMALL_FL = dict(participants_per_round=40, use_availability=False)
PAPER_SMALL_ROUNDS = 12
ACC_ROW_KEYS = ("target_acc", "base_final", "auxo_final", "worst10", "best10", "auxo_worst10", "ftfa_auxo")


@contextlib.contextmanager
def patched(mod, **attrs):
    """Set module attributes for the duration, then put the old ones back."""
    old = {k: getattr(mod, k) for k in attrs}
    for k, v in attrs.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def windowed(mod, counts, tag: str, runs: list, baselines: dict):
    """Wrap a driver module's run_fl / run_auxo and baseline classes: each
    call runs in a launch window of its own (``tag kind #i``) and its
    history (and baseline object) is recorded. Returns the attributes to
    patch."""
    attrs = {}
    for kind in ("run_fl", "run_auxo"):
        if hasattr(mod, kind):
            def call(*a, _o=getattr(mod, kind), _k=kind, **kw):
                with counts(f"{tag} {_k} #{len(runs)}"):
                    out = _o(*a, **kw)
                runs.append((_k, out[1] if _k == "run_auxo" else out))
                return out
            attrs[kind] = call
    for cls_name in ("IFCA", "FLHC", "FlexCFL", "CFL"):
        if hasattr(mod, cls_name):
            base = getattr(mod, cls_name)

            def run(self, _base=base, _n=cls_name):
                t0 = time.perf_counter()
                with counts(f"{tag} {_n.lower()}"):
                    hist = _base.run(self)
                baselines[_n] = (self, hist, time.perf_counter() - t0)
                return hist

            attrs[cls_name] = type(cls_name, (base,), {"run": run})
    return attrs


def paper_drivers(torch, device, counts) -> dict:
    """Phase 21a: every driver of ``repro_torch.paper`` at the cut above on
    ``device``, each run_fl / run_auxo / baseline in a launch window of its
    own (fig12's engine in one window), with each driver's rows, histories,
    baselines and seconds."""
    import importlib

    plan = [
        ("table3_tta", lambda m: m.run(PAPER_ROUNDS, scenarios=["openimage-like"], device=device)),
        ("table4_bias", lambda m: m.run(PAPER_ROUNDS, scenarios=["openimage-like"], device=device)),
        ("fig10_algorithms", lambda m: m.run(PAPER_ROUNDS, device=device)),
        ("fig12_correlation", lambda m: m.run(PAPER_ROUNDS, device=device)),
        ("fig13_sensitivity", lambda m: m.run(PAPER_ROUNDS, device=device)),
        ("fig14_resilience", lambda m: m.run(PAPER_ROUNDS, device=device)),
        ("table5_clustered_fl", lambda m: m.run(T5_ROUNDS, device=device)),
    ]
    out = {}
    for name, call in plan:
        mod = importlib.import_module(f"repro_torch.paper.{name}")
        runs, baselines = [], {}
        attrs = {**PAPER_CUTS.get(name, {}), **windowed(mod, counts, f"21 {name}", runs, baselines)}
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(mod, **attrs), (counts(f"21 {name} engine") if name == "fig12_correlation"
                                     else contextlib.nullcontext()):
            rows = call(mod)
        if device != "cpu":
            torch.cuda.synchronize()
        out[name] = dict(rows=rows, runs=runs, baselines=baselines, s=time.perf_counter() - t0)
        print(f"[paper] 21a {name}: {len(rows)} rows, {len(runs)} runs"
              + (f" and {len(baselines)} baselines" if baselines else "")
              + f" in {out[name]['s']:.2f} s", flush=True)
    return out


def check_paper_rows(out: dict):
    """21a's outputs: finite rows (fig13's no-baseline rows hold NaN by
    design), accuracies in [0, 1], Auxo partitioned where the cut lets it
    (Tables 3 and 4, FedYoGi under Figure 10, both Auxo runs of Table 5),
    and Table 5's cost invariants (phase 12c's)."""
    for name, d in out.items():
        for row in d["rows"]:
            for k, v in row.items():
                if isinstance(v, float) and not math.isfinite(v) and not (k == "base_final" and v != v):
                    raise AssertionError(f"21a {name}: {k} = {v} in {row}")
                if k in ACC_ROW_KEYS and v == v and not 0.0 <= v <= 1.0:
                    raise AssertionError(f"21a {name}: {k} = {v} outside [0, 1]")
        for kind, hist in d["runs"]:
            if not all(math.isfinite(h[k]) for h in hist for k in ("acc_mean", "resource", "time")):
                raise AssertionError(f"21a {name}: a non-finite history value in a {kind}")
    parted = [out["table3_tta"]["rows"][0]["n_cohorts"],
              out["table4_bias"]["runs"][1][1][-1]["n_cohorts"],
              out["fig10_algorithms"]["runs"][1][1][-1]["n_cohorts"]]
    parted += [h[-1]["n_cohorts"] for k, h in out["table5_clustered_fl"]["runs"] if k == "run_auxo"]
    if min(parted) < 2:
        raise AssertionError(f"21a: an Auxo run that should partition did not: n_cohorts {parted}")
    b = out["table5_clustered_fl"]["baselines"]
    fl = b["IFCA"][0].fl
    per_round = fl.participants_per_round * fl.local_steps * fl.batch_size
    full_pass = b["IFCA"][0].pop.n_clients * fl.local_steps * fl.batch_size
    if b["IFCA"][1][-1]["comm"] != T5_K * fl.participants_per_round * T5_ROUNDS:
        raise AssertionError(f"21a ifca: comm {b['IFCA'][1][-1]['comm']}")
    for n in ("FLHC", "FlexCFL"):
        if b[n][1][-1]["resource"] != T5_ROUNDS * per_round + full_pass:
            raise AssertionError(f"21a {n}: resource {b[n][1][-1]['resource']} lacks the full pass")
    cfl, hist, _ = b["CFL"]
    if hist[-1]["resource"] != cfl.pop.n_clients * cfl.fl.local_steps * cfl.fl.batch_size * cfl.fl.rounds:
        raise AssertionError(f"21a cfl: resource {hist[-1]['resource']} is not full participation")
    return parted


def paper_card_vs_cpu(torch, counts) -> dict:
    """Phase 21b: Table 3's driver on a 120-client cut of openimage-like,
    on the card and on the CPU: equal discrete fields (every history's
    round, resource, time and n_cohorts too), floats within the round
    tolerance (rtol 1e-4, atol 1e-5)."""
    from repro_torch.paper import common, table3_tta

    small = {**common.SCENARIOS["openimage-like"], "n_clients": PAPER_SMALL_CLIENTS}
    cut_fl = lambda rounds=100, seed=1, **kw: common.default_fl(rounds, seed, **{**PAPER_SMALL_FL, **kw})  # noqa: E731
    res = {}
    with patched(common, SCENARIOS={**common.SCENARIOS, "openimage-like": small}):
        for dev in ("cuda", "cpu"):
            runs = []
            attrs = {"default_fl": cut_fl, **windowed(table3_tta, counts, f"21b {dev}", runs, {})}
            with patched(table3_tta, **attrs):
                rows = table3_tta.run(PAPER_SMALL_ROUNDS, scenarios=["openimage-like"], device=dev)
            res[dev] = (rows, runs)
    (rg, hg), (rc, hc) = res["cuda"], res["cpu"]
    gap = 0.0
    for a, b in zip(rg, rc):
        for k, v in a.items():
            if isinstance(v, float):
                gap = max(gap, abs(v - b[k]))
                if not math.isclose(v, b[k], rel_tol=1e-4, abs_tol=1e-5):
                    raise AssertionError(f"21b {k}: card {v} vs CPU {b[k]}")
            elif v != b[k]:
                raise AssertionError(f"21b {k}: card {v} vs CPU {b[k]}")
    for (_, ha), (_, hb) in zip(hg, hc):
        for a, b in zip(ha, hb):
            if [a[k] for k in ("round", "resource", "time", "n_cohorts")] != \
                    [b[k] for k in ("round", "resource", "time", "n_cohorts")]:
                raise AssertionError(f"21b: history rows differ card {a['round']} vs CPU {b['round']}")
            for k in ("acc_mean", "acc_worst10", "acc_best10"):
                gap = max(gap, abs(a[k] - b[k]))
                if not math.isclose(a[k], b[k], rel_tol=1e-4, abs_tol=1e-5):
                    raise AssertionError(f"21b round {a['round']} {k}: card {a[k]} vs CPU {b[k]}")
    if len(rg) != len(rc) or len(hg) != len(hc) or rg[0]["n_cohorts"] < 2:
        raise AssertionError(f"21b: rows {rg} vs {rc}")
    return dict(rows=rg, gap=gap)


def paper_phase(torch, np, ops, ref, cs, sa) -> dict:
    """Phase 21: the paper's drivers on the card (21a), Table 3 card vs CPU
    (21b), then every call shape of the phase held against the plain
    version (21c). Plain versions raise on CUDA tensors throughout; every
    run's launches are counted from 0: Auxo runs launch both round kernels,
    the no-cohort runs and Figure 12's engine the segment kernel, the four
    baselines none."""
    t_phase = time.perf_counter()
    counts = Launches(cs, sa)
    shapes = {"cosine_similarity": {}, "segment_aggregate": {}}
    undo = [
        record(cs, "cosine_similarity",
               lambda x, c, eps=1e-8: (tuple(x.shape), tuple(c.shape), x.dtype),
               shapes["cosine_similarity"]),
        record(sa, "segment_aggregate",
               lambda d, i, k, w=None: (tuple(d.shape), int(k), d.dtype, w is not None),
               shapes["segment_aggregate"]),
        forbid_cuda_in_plain(torch, ref),
    ]
    try:
        drivers = paper_drivers(torch, "cuda", counts)
        small = paper_card_vs_cpu(torch, counts)
    finally:
        for u in undo:
            u()
    parted = check_paper_rows(drivers)
    for path, n in counts.by_path.items():
        kind = path.split()[2]
        if path.startswith("21b cpu"):
            want = n["cosine_similarity"] == n["segment_aggregate"] == 0
        elif kind == "run_auxo":
            want = min(n.values()) > 0
        elif kind in ("run_fl", "engine"):
            want = n["segment_aggregate"] > 0
        else:  # the baselines aggregate with a plain mean
            want = max(n.values()) == 0
        if not want:
            raise AssertionError(f"21: launches {n} on {path}")
    for name, d in drivers.items():
        for row in d["rows"]:
            print(f"[paper] 21a {name} {json.dumps(row)}", flush=True)
        for n, (obj, hist, s) in d["baselines"].items():
            agglo = getattr(obj, "agglomerative_s", None)
            print(f"[paper] 21a {name} {n}: acc_mean {hist[-1]['acc_mean']:.4f}, resource "
                  f"{hist[-1]['resource']:.0f}, comm {hist[-1].get('comm', '-')}, wall {s:.3f} s"
                  + ("" if agglo is None else f" (of it _agglomerative {agglo:.3f} s of host time)"), flush=True)
    print(f"[paper] 21a Auxo runs that partition: n_cohorts {parted}", flush=True)
    print(f"[paper] 21b Table 3 on {PAPER_SMALL_CLIENTS} clients, card == CPU discrete fields, floats "
          f"max |card - CPU| {small['gap']:.3e} (rtol 1e-4, atol 1e-5): {json.dumps(small['rows'])}", flush=True)
    # ------------------------------------------------ 21c: call shapes
    worst = check_rows(torch, ops, ref, list(shapes["cosine_similarity"]), list(shapes["segment_aggregate"]))
    by_driver = {}
    for path, n in counts.by_path.items():
        acc = by_driver.setdefault(path.split()[1] if path.startswith("21 ") else "21b card vs CPU",
                                   dict.fromkeys(ROUND_KERNELS, 0))
        for k in ROUND_KERNELS:
            acc[k] += n[k]
    secs = time.perf_counter() - t_phase
    print(f"[paper] launches by driver {by_driver}", flush=True)
    print(f"[paper] {len(shapes['cosine_similarity'])} cosine and {len(shapes['segment_aggregate'])} segment "
          f"call shapes of phase 21 held against the plain version: max |err| {worst}", flush=True)
    print(f"[paper] seconds by driver {({k: round(d['s'], 2) for k, d in drivers.items()})}; phase 21 took "
          f"{secs:.1f} s", flush=True)
    return dict(launches={k: sum(n[k] for n in counts.by_path.values()) for k in ROUND_KERNELS},
                by_driver=by_driver, by_path=counts.by_path, worst=worst, seconds=secs,
                driver_seconds={k: d["s"] for k, d in drivers.items()})


def paper_only(torch) -> int:
    """``--paper``: build, then phase 21 alone."""
    import numpy as np

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import segment_aggregate as sa

    card = smi()
    print(card)
    print(f"[build] {build.build()}")
    out = paper_phase(torch, np, ops, ref, cs, sa)
    print(json.dumps({"paper": {"by_driver": out["by_driver"], "max_abs_err": out["worst"],
                                "seconds": out["seconds"], "driver_seconds": out["driver_seconds"]}}))
    print(card)
    return 0


# --paper-full: the dry-run plans the roofline table reads (two archs), then
# every suite of ``python -m repro_torch.paper.run --full`` on the card
PAPER_FULL_DRYRUNS = (("granite-3-2b", "train_4k"), ("qwen3-moe-235b-a22b", "train_4k"))


def paper_full(torch) -> int:
    """``--paper-full``: build, the dry runs of ``PAPER_FULL_DRYRUNS``, then
    ``python -m repro_torch.paper.run --full`` on the card (its CSV blocks
    and each suite's seconds), in child processes that stop before this
    returns."""
    from repro_torch.kernels import build

    card = smi()
    print(card)
    print(f"[build] {build.build()}", flush=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    for arch, shape in PAPER_FULL_DRYRUNS:
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape],
                       cwd=ROOT, env=env, check=True, timeout=900)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "repro_torch.paper.run", "--full"], cwd=ROOT, env=env, check=True,
                   timeout=3000)
    print(f"[paper-full] python -m repro_torch.paper.run --full took {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    return 0


def row_json(sig, t):
    return {"shape": repr(sig), "ms": t["ms"], "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1]}


def kernel_timing_only(torch) -> int:
    """``--kernel-timing``: build, then phase 6's fixed rows of the segment
    and cosine kernels alone and the LM rows (1, 2, n) -> 1 weighted at
    n = 41.9M and 671M, and the rows as JSON (for timing two versions of
    the package in turns, ``--src``)."""
    from repro_torch.kernels import build, ops, ref

    so = build.build()
    if build.build_log:
        print(build.build_log)
    print(f"[build] {so}")
    one = torch.zeros(1, device="cuda")
    print(f"[timing] floor: one launch of a 1-element add_ {graph_ms(torch, lambda: one.add_(1)):.5f} ms "
          f"(the same graph timing)")
    rows = time_fixed_rows(torch, ops, ref, lm=True)
    print(json.dumps({"src": SRC, "kernel_timing": {
        f"{name}/{key}": row_json(sig, t) for name, key, sig, t in rows}}))
    print(smi())
    return 0


def decode_timing_only(torch) -> int:
    """``--decode-timing``: build, then phase 9 alone, and its rows as JSON
    (for timing two versions of the package in turns, ``--src``)."""
    from repro_torch.kernels import build, ops, ref

    so = build.build()
    if build.build_log:
        print(build.build_log)
    print(f"[build] {so}")
    rows = decode_timing(torch, ops, ref)
    print(json.dumps({"src": SRC, "decode_timing": {
        key: {"ms": t["ms"], "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
              "library_ms": t["library_ms"], "bound_ms": t["bound"][0]}
        for key, _, t in rows}}))
    print(smi())
    return 0


def main(argv) -> int:
    global SRC
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this check runs only on the card")
    if "--src" in argv:  # another copy of the package, e.g. an earlier commit's
        SRC = os.path.abspath(argv[argv.index("--src") + 1])
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"the port package is missing under {SRC}")
    sys.path.insert(0, SRC)
    if "--train-rank" in argv:
        return train_rank(torch, argv[argv.index("--train-rank") + 1:])
    if "--decode-timing" in argv:
        return decode_timing_only(torch)
    if "--kernel-timing" in argv:
        return kernel_timing_only(torch)
    if "--lm-train" in argv:
        return lm_only(torch)
    if "--engine-modes" in argv:
        return engine_modes_only(torch)
    if "--eval-baselines" in argv:
        return eval_baselines_only(torch)
    if "--families" in argv:
        return families_only(torch)
    if "--ssm" in argv:
        return ssm_only(torch)
    if "--placement" in argv:
        return placement_only(torch)
    if "--launch" in argv:
        return launch_only(torch)
    if "--spmd" in argv:
        return spmd_only(torch)
    if "--maverick" in argv:
        return maverick_only(torch)
    if "--drivers" in argv:
        return drivers_only(torch)
    if "--options" in argv:
        return options_only(torch)
    if "--paper" in argv:
        return paper_only(torch)
    if "--paper-full" in argv:
        return paper_full(torch)

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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_aggregate as sa
    worst = check_kernels(torch, ops, ref, cs, sa)
    worst["decode_attention"] = check_decode(torch, ops, ref, da)
    print(f"[kernels] kernel vs plain max |err|: {worst} "
          f"(tolerances f32 2e-5, bf16 2e-2 cosine / 3e-2 decode; the segment kernel bit-equal to "
          f"the plain version on a CPU copy; "
          f"decode bit-identical across launches)")
    result = {"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}
    if "--kernels-only" in argv:
        print(card)
        print(json.dumps(result))
        return 0

    # ------------------------------------ phase 4a: small run, card vs CPU
    parts, err, small = small_reference(torch)
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
    del eng2

    # ------------------------------------- phase 7: paged cohort decode
    import numpy as np
    dec = decode_phase(torch, np, ops, ref, "--profile" in argv)
    ties = dec["tie_steps"]
    print(f"[decode] {GRANITE} full width ({dec['n_params']:,} params, f32), bank of 3 slots "
          f"({dec['bank_gb']:.2f} GB, drawn in {dec['init_s']:.2f} s), 2 live cohorts x "
          f"{DECODE_LANES} lanes, {DECODE_STEPS} steps, partition [0, 1] -> [1, 2], "
          f"{DECODE_STEPS} more: decode kernel launches {dec['launches']} = {dec['n_steps']} "
          f"steps x {dec['n_layers']} layers, every one held against the plain version on the "
          f"same inputs: max |err| {dec['call_err'][0]:.3e}, at most "
          f"{dec['call_err'][3]:.3f} of the tolerance (2e-5 + {NOISE_FACTOR} x the float32 "
          f"rounding of the inputs); max |err| against float64: kernel "
          f"{dec['call_err'][1]:.3e}, plain {dec['call_err'][2]:.3e}")
    print(f"[decode] kernel vs plain decoder, teacher-forced with the plain tokens: "
          f"{'identical greedy tokens at every step' if not ties else 'identical greedy tokens except near ties (step, lanes) ' + str(ties)}; "
          f"max |logit err| {dec['max_err']:.3e}, by step "
          f"{[float(f'{e:.3g}') for e in dec['logit_errs']]}")
    print(f"[decode] {dec['call_tok_s']:.1f} tokens/s per 16-step call (params gather included), "
          f"{dec['step_tok_s']:.1f} tokens/s per step: {dec['step_ms']:.3f} ms/step against the "
          f"weight-bytes bound {dec['bound_ms']:.3f} ms (2 rows x {dec['n_params'] * 4 / 1e9:.2f} GB "
          f"at 3.35 TB/s) = {100 * dec['bound_ms'] / dec['step_ms']:.1f}% of the bound; "
          f"peak memory {dec['peak_gb']:.2f} GB")
    if dec["table"]:
        print(dec["table"])

    # ----------------------------------------- phase 8: serving plane
    srv = serving_phase(torch, np, eng)
    print(f"[serving] 2000-query burst (90% hot, max_batch 256): {srv['qps']:.1f} queries/s "
          f"({srv['wall']:.4f} s), {srv['batches']} admitted batches = {srv['batches']} inferences, "
          f"{srv['probes']} probe batches; {srv['hot']} hot / {srv['cold']} cold clients over "
          f"slots {srv['slots']}; a repeated cold batch came from the probe cache")

    # ------------------------------------------------------ phase 6: timing
    report = []
    meta = {
        "cosine_similarity": ("src/repro_torch/kernels/csrc/cosine_sim.cu",
                              "src/repro/kernels/cosine_sim.py:46", time_cosine),
        "segment_aggregate": ("src/repro_torch/kernels/csrc/segment_aggregate.cu",
                              "src/repro/kernels/segment_aggregate.py:46", time_segment),
    }
    fixed = time_fixed_rows(torch, ops, ref)
    for name, (source, replaces, timer) in meta.items():
        # the call with the most bytes represents the kernel in the report;
        # then the next largest, and the largest D = 1 call
        sigs = sorted(shapes[name], key=lambda s: -int(torch.Size(s[0]).numel()))
        timed = sigs[:TIMED_SHAPES]
        narrow = [s for s in sigs if s[0][-1] == 1]
        if narrow and narrow[0] not in timed:
            timed.append(narrow[0])
        rows = []
        for sig in timed:
            t = timer(torch, ops, ref, sig)
            rows.append((sig, t))
            print_row(name, f"{sig} x{shapes[name][sig]} per main run", t)
        sig, t = rows[0]
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "shape": repr(sig), "eager_ms": t["eager_ms"],
            "rows": {key: row_json(sg, tt) for n, key, sg, tt in fixed if n == name},
        })
    # ------------------------------------- phase 9: decode attention timing
    gc.collect()
    torch.cuda.empty_cache()  # phase 7's bank and cache are gone: room for the 8.6 GB batch
    dec_rows = decode_timing(torch, ops, ref)
    key, name, t = dec_rows[0]
    row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:72",
        "launches": dec["launches"], "max_abs_err": worst["decode_attention"],
        "main_path_max_abs_err": dec["call_err"][0],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": t["library_ms"],
        "shape": name, "eager_ms": t["eager_ms"],
    }
    for key, name, t in dec_rows[1:]:
        row[key] = {"shape": name, "ms": t["ms"], "eager_ms": t["eager_ms"],
                    "bound_ms": t["bound"][0], "plain_ms": t["plain_ms"],
                    "library_ms": t["library_ms"]}
    report.append(row)

    # ------------------------------------------------- phase 10: LM training
    lm = run_lm_phase(torch, np, ops, ref)
    if lm["launches"] <= 0:
        return fail("the LM path never launched the segment kernel")
    seg = next(r for r in report if r["name"] == "segment_aggregate")
    seg["lm_launches"] = lm["launches"]
    seg["lm_rows"] = lm["rows"]
    seg["max_abs_err"] = max(seg["max_abs_err"], lm["worst"])

    # ------------------------------------------------- phase 11: engine modes
    gc.collect()
    torch.cuda.empty_cache()
    modes = engine_modes_phase(torch, ops, ref, cs, sa, secs)
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["engine_modes_launches"] = modes["launches"][r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], modes["worst"][r["name"]])

    # ------------------------------------------ phase 12: evaluation, baselines
    gc.collect()
    torch.cuda.empty_cache()
    ev = eval_baselines_phase(torch, np, ops, ref, cs, sa, eng, small)
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["eval_baselines_launches"] = ev["launches"][r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], ev["worst"][r["name"]])

    # ------------------------------------------------ phase 13: model families
    del eng, small
    fam = families_phase(torch, np, ops, ref, sa, card)
    if fam["launches"] <= 0:
        return fail("phase 13 never launched the segment kernel")
    seg = next(r for r in report if r["name"] == "segment_aggregate")
    seg["phase13_launches"] = fam["launches"]
    seg["max_abs_err"] = max(seg["max_abs_err"], fam["worst"])

    # ------------------------------------------- phase 14: SSM and hybrid
    ssm = ssm_phase(torch, np, ops, ref, sa, card)
    if ssm["launches"] <= 0:
        return fail("phase 14 never launched the segment kernel")
    seg["phase14_launches"] = ssm["launches"]
    seg["phase14_largest"] = ssm["row"]
    seg["max_abs_err"] = max(seg["max_abs_err"], ssm["worst"])

    # ------------------------------------------------- phase 15: placement
    gc.collect()
    torch.cuda.empty_cache()
    pl = placement_phase(torch, np, ops, ref, cs, sa)
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["placement_launches"] = pl["launches"][r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], pl["worst"][r["name"]])

    # --------------------------------------------------- phase 16: launch plan
    out16 = launch_phase(torch, card, {"10b": lm["peak_gb"], "13b": fam["qwen3"]["peak_gb"]})

    # ---------------------------------------------------- phase 17: SPMD probe
    sp = spmd_phase(torch, card, out16["plans"], ops, ref, cs, sa)
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["spmd_launches"] = sp["launches"][r["name"]]

    # ------------------------------------ phase 18: llama4-maverick, full width
    mav = maverick_phase(torch, card, ops, ref, cs, sa)
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["maverick_launches"] = mav["launches"][r["name"]]

    # ----------------- phase 19: split decode, launch.train's ranks, the examples
    drv = drivers_phase(torch, np, ops, ref, card, cs, sa)
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["drivers_launches"] = drv["launches"][r["name"]]

    # ------------------------------------------ phase 20: the reference's last options
    gc.collect()
    torch.cuda.empty_cache()
    opts = options_phase(torch, np, ops, ref, card)
    if opts["launches"]["segment_aggregate"] <= 0:
        return fail("phase 20 never launched the segment kernel")
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["options_launches"] = opts["launches"][r["name"]]

    # ------------------------------------------------- phase 21: the paper's drivers
    gc.collect()
    torch.cuda.empty_cache()
    pap = paper_phase(torch, np, ops, ref, cs, sa)
    for r in report:
        if r["name"] in ROUND_KERNELS:
            r["paper_launches"] = pap["launches"][r["name"]]
            r["paper_launches_by_driver"] = {k: v[r["name"]] for k, v in pap["by_driver"].items()}
            r["max_abs_err"] = max(r["max_abs_err"], pap["worst"][r["name"]])
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
