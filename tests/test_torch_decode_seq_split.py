"""Decode on a KV cache split on its sequence (``models.common.
_attention_decode_spmd``) on the CPU.

- On a (2, 2) ("data", "model") mesh of a 4-rank ``gloo`` group
  (``tests/test_torch_spmd_worker.py``), reduced granite (its sliding-window
  variant) and zamba2 take three decode steps from a prefilled cache:
  at batch 1 with the cache placed by ``cache_shardings`` (the data axis on
  the ring, ``model`` on hd: long_500k's placement), and at batch 2 under
  ``seq_shard=True`` (``model`` on the ring: ``--cache-seq-shard``), both
  from an index past the ring's wrap with a window shorter than the ring;
  and at batch 2 under ``seq_shard=True`` on a full cache whose second
  card's slots are not yet written. Logits and the whole cache equal one
  device at rtol 1e-4, atol 1e-5.
- Reduced musicgen's codebook lookups and heads on the same group (they
  took paths of DTensor's own that fake tensors cannot run), and its three
  kinds of the split decode, the batch-2 ring's cache at a tolerance set
  beside float32 rounding's own reach on one device.
- The dry run plans the reduced archs at long_500k and under
  ``--cache-seq-shard`` on a (2, 2) fake mesh, with the softmax's MAX and
  SUM all-reduces among its collectives, and granite-3-2b at full width
  on the production mesh.
"""
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.specs import SDS, effective_config
from test_torch_profile import _assert_trees_close, _gloo

SEQ_KINDS = ("decode_ring", "decode_seq", "decode_seq_full")


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_7b"])
def test_gloo_sequence_split_decode_equals_one_device(tmp_path, arch):
    res = _gloo(tmp_path, arch, ",".join(SEQ_KINDS))
    for kind in SEQ_KINDS:
        _assert_trees_close(res[kind]["spmd"], res[kind]["one"], kind)
        assert set(res[kind]["spmd"]) == {"logits0", "logits1", "logits2", "cache"}


# Musicgen's decode_seq cache: rtol 1e-4 and an atol of 3.6e-6 of the
# leaves' scale (~14). The split's largest gaps to one device are 2.7e-5 (k,
# on an element near 0: 1.3x the common atol of 1e-5) and 2.3e-5 (v). One
# device's own cache moves 3.1e-5 (k) and 3.5e-5 (v) when each param moves
# one ulp (the worker's ``one_ulp``), so the gap is float32's.
MUSICGEN_SEQ_CACHE_ATOL = 5e-5


def test_gloo_codebook_heads_and_lookup_equal_one_device(tmp_path):
    """Reduced musicgen's codebook tables and heads on DTensors (each table
    looked up as a vocab-split table, each head partitioned as a dot): two
    decode steps under tp at batch 4, three at batch 1 on the ring, three
    under ``seq_shard`` past the ring's wrap and on a full cache, and a
    prefill equal one device. Under ``seq_shard`` past the wrap, the cache's
    largest gap to one device is at most twice the gap that one-ulp moves of
    the params give one device alone."""
    kinds = ("decode", "decode_ring", "decode_seq", "decode_seq_full", "prefill")
    res = _gloo(tmp_path, "musicgen_large", ",".join(kinds))
    for kind in kinds:
        if kind != "decode_seq":
            _assert_trees_close(res[kind]["spmd"], res[kind]["one"], kind)
    got, want, ulp = (res["decode_seq"][k] for k in ("spmd", "one", "ulp"))
    _assert_trees_close({k: v for k, v in got.items() if k != "cache"},
                        {k: v for k, v in want.items() if k != "cache"}, "decode_seq")
    for name in ("k", "v"):
        a, b, c = (r["cache"]["blocks"][name] for r in (got, want, ulp))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=MUSICGEN_SEQ_CACHE_ATOL, msg=f"decode_seq cache {name}")
        assert (a - b).abs().max() <= 2 * (c - b).abs().max(), name


@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mini_long_cfg(arch):
    """The reduced arch's long_500k variant: a 64-slot ring."""
    cfg = reduce_config(get_config(arch)).replace(dtype=torch.bfloat16, d_model=256, n_heads=8, n_kv_heads=4,
                                                  attn_qchunk=16, ce_chunk=32)
    cfg = cfg.replace(ssm_heads=8) if cfg.family == "hybrid" else cfg
    return effective_config(cfg, SHAPES["long_500k"]).replace(sliding_window=64)


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_7b", "musicgen_large"])
@pytest.mark.parametrize("batch, seq_shard", [(1, False), (8, True)])
def test_mini_dry_run_plans_a_sequence_split_decode(arch, batch, seq_shard):
    """Batch 1: the data axis on the ring, ``model`` on hd; batch 8 under
    ``seq_shard``: the batch over data, ``model`` on the ring. Each
    attention layer all-reduces its softmax's max and sum over the split:
    two float32 (b, n_kv, 1, g, 1) all-reduces per layer of the probe."""
    lmesh.init_fake_world(4)
    mesh = lmesh.make_mesh((2, 2), ("data", "model"), dryrun.fake_device())
    cfg, sc = _mini_long_cfg(arch), steps.StepConfig(d_sketch=32)
    tokens = {"tokens": SDS((batch,) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (1,), torch.int32)}
    plan = dryrun.plan_step(cfg, "decode", tokens, mesh, "tp", sc, cache_len=512, seq_shard_cache=seq_shard)
    assert plan["fits"] and plan["state_by_part"]["cache"] > 0 and plan["flops_probe"] > 0
    assert plan["roofline"]["coll_by_op"]["all-reduce"] > 0
    counts = dryrun.probe_step(dryrun._with_units(cfg, 1), "decode", tokens, sc, cache_len=512, mesh=mesh,
                               seq_shard_cache=seq_shard)
    b, g = batch // 2 if seq_shard else batch, cfg.n_heads // cfg.n_kv_heads
    stats = [r for r in counts.collectives if r == ("all-reduce", (b, cfg.n_kv_heads, 1, g, 1), torch.float32)]
    assert len(stats) == 2


@pytest.mark.parametrize("shape, seq_shard", [("long_500k", False), ("decode_32k", True)])
def test_granite_plans_on_the_production_mesh(shape, seq_shard):
    rep = dryrun.lower_one("granite-3-2b", shape, False, seq_shard_cache=seq_shard)
    assert rep["fits"] and rep["kind"] == "decode"
    assert rep["variant"] == ("sliding_window" if shape == "long_500k" else "native")
    assert rep["roofline"]["coll_bytes_per_device"] > 0
