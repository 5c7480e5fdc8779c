"""The port's dry run (``repro_torch.launch.dryrun``, ``repro_torch.utils.hlo``)
on the CPU: the roofline at the H100's constants and the collective sums
against the JAX package's ``tests/test_hlo.py`` sample, the tree helpers
against the JAX package's, and a mini dry run of reduced granite,
qwen3-moe and zamba2 on a (2, 2) mesh of the fake process group (the SPMD
probe: every step one program over the mesh, on fake tensors), and on a
(1, 1) mesh, where it records no collective. Also: ``clustering_update`` keeps its bits after it
stopped indexing with a tensor scalar, and a fake CUDA tensor takes the
kernels' shape rules, never a launch or a plain version."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.specs import SDS
from repro_torch.utils import hlo
from repro_torch.utils import tree as ttree

# tests/test_hlo.py's SAMPLE, as recorded collectives (op, per-card shape, dtype)
RECORDS = [("all-reduce", (1024, 2048), torch.bfloat16), ("all-gather", (64, 512), torch.float32),
           ("all-to-all", (8, 128), torch.bfloat16), ("collective-permute", (16, 16), torch.float32),
           ("reduce-scatter", (32, 32), torch.float32)]


def test_collective_bytes_match_the_reference_sample():
    from test_hlo import SAMPLE

    from repro.utils.hlo import collective_bytes as jax_collective_bytes

    assert hlo.collective_bytes(RECORDS) == jax_collective_bytes(SAMPLE)
    # a tuple-shaped all-gather is two records
    tup = hlo.collective_bytes([("all-gather", (4, 4), torch.bfloat16), ("all-gather", (2, 2), torch.float32)])
    assert tup["all-gather"] == 4 * 4 * 2 + 2 * 2 * 4


def test_roofline_terms_and_bottleneck_at_h100_constants():
    r = hlo.Roofline(flops=hlo.PEAK_FLOPS, bytes_accessed=0.0, coll_bytes=0.0, coll_by_op={})
    assert r.compute_s == 1.0 and r.bottleneck == "compute"
    r2 = hlo.Roofline(flops=0.0, bytes_accessed=3.35e12 * 2, coll_bytes=0.0, coll_by_op={})
    assert r2.memory_s == 2.0 and r2.bottleneck == "memory"
    r3 = hlo.Roofline(flops=0.0, bytes_accessed=0.0, coll_bytes=900e9 * 3, coll_by_op={})
    assert r3.collective_s == 3.0 and r3.bottleneck == "collective"
    assert hlo.peak_flops(torch.bfloat16) == 989e12 and hlo.peak_flops(torch.float32) == 67e12
    # float32's peak, and the bottleneck over all three terms
    r4 = hlo.Roofline(flops=67e12, bytes_accessed=3.35e12 * 2, coll_bytes=900e9 * 1.5, coll_by_op={},
                      peak_flops=hlo.PEAK_FLOPS_F32)
    d = r4.as_dict()
    assert d["collective_s"] == 1.5 and d["compute_s"] == 1.0 and d["bottleneck"] == "memory"


def test_tree_helpers_match_the_reference():
    import jax.numpy as jnp

    from repro.utils import tree as jtree

    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32), "n": np.arange(6, dtype=np.int32)}}
    jt = {"a": jnp.asarray(arrays["a"]), "b": {"c": jnp.asarray(arrays["b"]["c"]), "n": jnp.asarray(arrays["b"]["n"])}}
    tt = ttree.tree_map(torch.from_numpy, arrays)
    floats = {"a": tt["a"], "b": {"c": tt["b"]["c"]}}
    jfloats = {"a": jt["a"], "b": {"c": jt["b"]["c"]}}
    np.testing.assert_allclose(float(ttree.tree_norm(floats)), float(jtree.tree_norm(jfloats)), rtol=1e-6)
    assert ttree.tree_size(tt) == jtree.tree_size(jt) == 23
    assert ttree.tree_bytes(tt) == jtree.tree_bytes(jt) == 23 * 4
    cast, jcast = ttree.tree_cast(tt, torch.bfloat16), jtree.tree_cast(jt, jnp.bfloat16)
    for (path, got), want in zip(ttree.leaves_with_path(cast), [jcast["a"], jcast["b"]["c"], jcast["b"]["n"]]):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path  # floats only: int32 stays
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------ the mini dry run
@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def mesh22():
    lmesh.init_fake_world(4)
    return lmesh.make_mesh((2, 2), ("data", "model"), dryrun.fake_device())


@pytest.fixture
def mesh11():
    lmesh.init_fake_world(1)
    return lmesh.make_mesh((1, 1), ("data", "model"), dryrun.fake_device())


def _mini_cfg(arch):
    """tests/test_dryrun_mini.py's reduced configs (larger attention and CE
    chunks: fewer ops to replay on fake tensors)."""
    cfg = reduce_config(get_config(arch)).replace(dtype=torch.bfloat16, d_model=256, n_heads=8,
                                                  n_kv_heads=4, attn_qchunk=16, ce_chunk=32)
    return cfg.replace(ssm_heads=8) if cfg.family == "hybrid" else cfg


MINI_BATCH = {"tokens": SDS((4, 2, 32), torch.int32)}
MINI_STEP = steps.StepConfig(d_sketch=32)


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b", "zamba2_7b"])
def test_mini_dry_run_plans_train_and_serve(mesh22, arch):
    cfg = _mini_cfg(arch)
    plan = dryrun.plan_step(cfg, "train", MINI_BATCH, mesh22, "tp", MINI_STEP)
    assert plan["step"] == "federated_train" and plan["local_batch"] == {"tokens": [2, 2, 32]}
    assert plan["flops_probe"] > 0 and plan["roofline"]["flops_per_device"] > 0
    assert plan["plan_bytes"] >= plan["state_bytes"] > 0 and plan["step_peak_bytes"] > 0
    assert plan["fits"]
    # the sharded step communicates (the reference's mini test asserts coll > 0)
    for p in (plan, dryrun.plan_step(cfg, "decode", {"tokens": SDS((8, 1), torch.int32)}, mesh22, "tp",
                                     MINI_STEP, cache_len=64)):
        roof = p["roofline"]
        assert roof["coll_bytes_per_device"] > 0 and roof["collective_s"] > 0 and min(p["probes"]["n_collectives"]) > 0
        assert sum(roof["coll_by_op"].values()) > 0 and "collectives" not in roof
        terms = {k: roof[f"{k}_s"] for k in ("compute", "memory", "collective")}
        assert roof["bottleneck"] == max(terms, key=terms.get)
    serve = p
    assert serve["state_by_part"]["cache"] > 0 and serve["plan_bytes"] >= serve["state_bytes"]
    assert serve["flops_probe"] > 0


@pytest.mark.parametrize("kind, batch, policy", [("train", MINI_BATCH, "tp"),
                                                 ("train", {"tokens": SDS((8, 32), torch.int32)}, "fsdp"),
                                                 ("prefill", {"tokens": SDS((4, 32), torch.int32)}, "tp"),
                                                 ("decode", {"tokens": SDS((8, 1), torch.int32)}, "tp")])
def test_one_card_mesh_records_no_collective(mesh11, kind, batch, policy):
    """On a (1, 1) mesh the SPMD probe records exactly 0 collectives, and
    its FLOPs are the plain (one-device) probe's."""
    cfg = _mini_cfg("granite_3_2b")
    plan = dryrun.plan_step(cfg, kind, batch, mesh11, policy, MINI_STEP, cache_len=64)
    roof = plan["roofline"]
    assert plan["probes"]["n_collectives"] == [0, 0] and roof["coll_bytes_per_device"] == 0
    assert roof["collective_s"] == 0.0 and roof["bottleneck"] in ("compute", "memory")
    one = dryrun.probe_step(dryrun._with_units(cfg, 1), kind, batch, MINI_STEP, kind == "train" and policy == "fsdp",
                            cache_len=64)
    assert plan["probes"]["flops"][0] == one.flops and one.collectives == ()


def test_extrapolation_equals_a_direct_three_unit_count(mesh22):
    """granite's 1- and 2-unit probes, extrapolated to 3 units, give the
    FLOPs and the collective bytes (by op and weighted) of a 3-unit probe;
    the step peak is the plan's own 3-unit probe's."""
    cfg = _mini_cfg("granite_3_2b")
    plan = dryrun.plan_step(cfg.replace(n_layers=3), "train", MINI_BATCH, mesh22, "tp", MINI_STEP)
    direct = dryrun.probe_step(dryrun._with_units(cfg, 3), "train", MINI_BATCH, MINI_STEP, mesh=mesh22, policy="tp")
    assert plan["probes"]["n_units"] == 3
    assert plan["flops_probe"] == direct.flops
    assert plan["step_peak_bytes"] == direct.step_peak_bytes
    coll = hlo.collective_bytes(direct.collectives)
    assert plan["roofline"]["coll_bytes_per_device"] == coll["total_weighted"] > 0
    assert plan["roofline"]["coll_by_op"] == {k: v for k, v in coll.items() if k != "total_weighted"}


def test_step_peak_takes_the_largest_per_unit_step(mesh22):
    """Past 2 units the plan probes 3 units too and extrapolates the step
    peak from the last probe by the largest per-unit step, so a peak whose
    growth rises with depth (one moment of the step overtaking another) is
    not planned below it; at 4 units the mini granite plan equals a direct
    4-unit probe."""
    assert dryrun._extrap_peak([10.0, 12.0, 17.0], 8) == 17.0 + 5 * 5.0
    assert dryrun._extrap_peak([10.0, 16.0, 17.0], 8) == 17.0 + 5 * 6.0
    assert dryrun._extrap_peak([10.0, 12.0], 3) == dryrun._extrap(10.0, 12.0, 3) == 14.0
    cfg = _mini_cfg("granite_3_2b")
    plan = dryrun.plan_step(cfg.replace(n_layers=4), "train", MINI_BATCH, mesh22, "tp", MINI_STEP)
    direct = dryrun.probe_step(dryrun._with_units(cfg, 4), "train", MINI_BATCH, MINI_STEP, mesh=mesh22, policy="tp")
    assert plan["probes"]["units"] == [1, 2, 3] and plan["probes"]["n_units"] == 4
    assert plan["step_peak_bytes"] == direct.step_peak_bytes


# ------------------------------------------------ the step and the kernels
@pytest.mark.parametrize("C, d, k", [(8, 32, 2), (33, 128, 4), (5, 16, 3)])
def test_clustering_update_keeps_its_bits(monkeypatch, C, d, k):
    """The bootstrap's row of seed0 is read by ``index_select`` (fake
    tensors cannot give the host read that ``sims_all[seed0]``, a
    tensor-scalar index, makes); both forms give the same bits."""
    g = torch.Generator().manual_seed(C + d)
    sketches = torch.randn(C, d, generator=g)
    state = steps.clustering_init(k, d, device="cpu")
    after = steps.clustering_update(state, sketches)
    index_select = torch.index_select
    monkeypatch.setattr(torch, "index_select", lambda t, dim, i: t[i[0]][None])  # sims_all[seed0]
    before = steps.clustering_update(state, sketches)
    monkeypatch.setattr(torch, "index_select", index_select)
    for x, y in zip(ttree.leaves(after[0]) + ttree.leaves(after[1]), ttree.leaves(before[0]) + ttree.leaves(before[1])):
        assert torch.equal(x, y)
    # and the later rounds, which keep their centroids
    again = steps.clustering_update(after[0], sketches.flip(0))
    assert torch.isfinite(again[0]["centroids"]).all()


def test_fake_cuda_tensors_take_the_kernels_shape_rules(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    from repro_torch.kernels import build, ref

    def boom(*a, **k):
        raise AssertionError("a fake tensor reached a launch or a plain version")

    for name in ("segment_aggregate", "cosine_similarity", "decode_attention"):
        monkeypatch.setattr(ref, name, boom)
    monkeypatch.setattr(build, "launch", boom)
    monkeypatch.setattr(build, "library", boom)
    with FakeTensorMode():
        x = torch.empty(3, 50, 70, device="cuda", dtype=torch.bfloat16)
        ids = torch.zeros(3, 50, dtype=torch.int32, device="cuda")
        w = torch.empty(3, 50, device="cuda")
        outs = [(ops.segment_aggregate(x, ids, 5, w), (3, 5, 70), torch.float32),
                (ops.segment_aggregate(x.select(0, 0), ids.select(0, 0), 5), (5, 70), torch.float32),
                (ops.cosine_similarity(x, torch.empty(3, 4, 70, device="cuda", dtype=torch.bfloat16)),
                 (3, 50, 4), torch.float32)]
        q, kv = torch.empty(2, 8, 64, device="cuda"), torch.empty(2, 128, 2, 64, device="cuda")
        n = torch.full((2,), 5, dtype=torch.int32, device="cuda")
        outs.append((ops.decode_attention(q, kv, kv, n), (2, 8, 64), torch.float32))
        outs.append((ops.decode_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16(), n), (2, 8, 64),
                     torch.bfloat16))
    for out, shape, dtype in outs:
        assert is_fake(out) and out.device.type == "cuda"
        assert tuple(out.shape) == shape and out.dtype == dtype


@pytest.mark.parametrize("grad_t,out_t,copies", [(False, False, 1), (True, False, 2), (False, True, 2),
                                                 (True, True, 3)])
def test_softmax_backward_scratch_counts_in_the_peak(grad_t, out_t, copies):
    """The softmax backward's CUDA kernel holds ``grad * output`` and a
    contiguous copy of each operand that is not contiguous (measured on the
    card): the counter's peak holds that scratch above its inputs and
    result, and nothing stays live after the op."""
    def arg(t):
        x = torch.randn(4, 3, 32)
        return x.transpose(0, 1).contiguous().transpose(0, 1) if t else x

    grad, out = arg(grad_t), arg(out_t)
    counter = hlo.StepCounter()
    for t in (grad, out):
        counter.track(t)
    base = counter.live
    with counter:
        torch.ops.aten._softmax_backward_data(grad, out, -1, torch.float32)
    n = grad.numel() * 4
    assert counter.peak == base + n + copies * n  # the result and the scratch


def test_a_query_that_returns_no_tensor_moves_no_bytes():
    """``prim::device`` (which a view of a fake tensor dispatches) returns a
    ``torch.device``: the counter charges it nothing, as XLA's cost
    analysis counts no such op, while a matmul still counts its bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        x = mode.from_tensor(torch.empty(24, 40))
        w = mode.from_tensor(torch.empty(40, 56))
        counter = hlo.StepCounter()
        with counter:
            torch.ops.prim.device.default(x)
            x.view_as(x)
            assert x.device.type == "cpu"
        assert counter.bytes_accessed == 0
        with counter:
            x @ w
    assert counter.bytes_accessed == 4 * (24 * 40 + 40 * 56 + 24 * 56)
    assert counter.flops == 2 * 24 * 40 * 56


def test_mini_probe_counts_no_more_than_its_tensor_returning_ops(mesh22, monkeypatch):
    """A 1-unit probe of reduced llama4-maverick's central step under fsdp
    dispatches ``prim::device`` many times; its counted bytes are at most
    the bytes of the ops that return a tensor (views and allocations
    aside)."""
    from torch.utils._pytree import tree_flatten

    seen = {"prim::device": 0, "bytes": 0}
    orig = hlo.StepCounter.__torch_dispatch__

    def tensors(tree):
        return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

    def dispatch(self, func, types, args=(), kwargs=None):
        paused = self._paused
        out = orig(self, func, types, args, kwargs)
        if out is NotImplemented:
            return out
        outs = tensors(out)
        if func.name() == "prim::device":
            seen["prim::device"] += 1
        elif (outs and not paused and not func.is_view and not func.name().startswith("aten::empty")
              and all(t.device.type != "meta" for t in outs)):
            seen["bytes"] += sum(hlo._tensor_bytes(t) for t in tensors((args, kwargs or {})) + outs)
        return out

    monkeypatch.setattr(hlo.StepCounter, "__torch_dispatch__", dispatch)
    cfg = _mini_cfg("llama4_maverick_400b_a17b")
    counts = dryrun.probe_step(dryrun._with_units(cfg, 1), "train", {"tokens": SDS((8, 32), torch.int32)},
                               MINI_STEP, True, mesh=mesh22, policy="fsdp")
    assert seen["prim::device"] > 100
    assert 0 < counts.bytes_accessed <= seen["bytes"]


def test_lower_one_without_probes_counts_the_whole_step():
    """``lower_one(probes=False)`` plans from one count of the whole step
    (``roofline_extrapolated`` false, as the reference reports it without
    its probes); at 2 layers the probes' extrapolation to 2 units is that
    count itself."""
    kw = dict(cfg_overrides={"n_layers": 2})
    once = dryrun.lower_one("granite-3-2b", "decode_32k", False, probes=False, **kw)
    probed = dryrun.lower_one("granite-3-2b", "decode_32k", False, **kw)
    assert once["roofline_extrapolated"] is False and probed["roofline_extrapolated"] is True
    assert once["probes"]["units"] == [2] and probed["probes"]["units"] == [1, 2]
    assert once["memory"] == probed["memory"]
    for k in ("flops_per_device", "bytes_per_device", "coll_bytes_per_device", "coll_by_op"):
        assert once["roofline"][k] == probed["roofline"][k], k
