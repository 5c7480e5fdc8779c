"""The port's launch specs and placement (``repro_torch.launch.specs``,
``mesh`` and ``sharding``) against the JAX package's, leaf by leaf, with
the reference tests' ``FakeMesh`` (no devices); then the placement itself
on the fake process group: the production mesh's extents, and
``per_card_bytes`` against the local shards that ``distribute_tensor``
gives under ``FakeTensorMode``."""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from test_sharding import MULTI, SINGLE, FakeMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs
from repro_torch.models import build_model
from repro_torch.utils.tree import leaves_with_path

MESHES = {"16x16": SINGLE, "2x16x16": MULTI}
POLICIES = ["tp", "fsdp", "ep", "dp"]
DECODE_SHAPES = ["decode_32k", "long_500k"]


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    """{key path: shape} of the JAX package's and the port's param trees."""
    jx = {jax.tree_util.keystr(p): tuple(l.shape)
          for p, l in jax.tree_util.tree_leaves_with_path(jbuild(jget_config(arch)).init_shapes())}
    pt = {p: tuple(l.shape) for p, l in leaves_with_path(build_model(get_config(arch)).init_shapes())}
    return jx, pt


@functools.lru_cache(maxsize=None)
def _cache_shapes(arch, shape_name):
    """{key path: shape} of both packages' decode caches at an input shape."""
    sh = SHAPES[shape_name]
    jcfg = jspecs.effective_config(jget_config(arch), JSHAPES[shape_name])
    jc = jax.eval_shape(lambda: jbuild(jcfg).init_cache(sh.global_batch, sh.seq_len, jnp.bfloat16))
    jx = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in jax.tree_util.tree_leaves_with_path(jc)}
    cfg = specs.effective_config(get_config(arch), sh)
    tc = build_model(cfg).init_cache(sh.global_batch, sh.seq_len, torch.bfloat16, device="meta")
    return jx, {p: tuple(l.shape) for p, l in leaves_with_path(tc)}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
def test_param_spec_equals_reference(arch, mesh, policy):
    jx, pt = _param_shapes(arch)
    assert jx == pt  # the same key paths and shapes
    m = MESHES[mesh]
    for path, shape in pt.items():
        assert shd.param_spec(path, shape, m, policy) == tuple(jshd.param_spec(path, shape, m, policy)), path


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("seq_shard", [False, True])
def test_batch_and_cache_specs_equal_reference(arch, shape_name, seq_shard):
    jx, pt = _cache_shapes(arch, shape_name)
    assert jx == pt
    B = SHAPES[shape_name].global_batch
    toks = specs.input_specs(get_config(arch), shape_name)["tokens"].shape
    for m in MESHES.values():
        for path, shape in pt.items():
            assert shd.cache_spec(shape, B, m, seq_shard) == tuple(jshd.cache_spec(shape, B, m, seq_shard)), path
        assert shd.batch_spec(toks, m) == tuple(jshd.batch_spec(toks, m))


_JDT = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_input_specs_equal_reference(arch, shape_name):
    want = jspecs.input_specs(jget_config(arch), shape_name)
    got = specs.input_specs(get_config(arch), shape_name)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == tuple(s.shape) and got[k].dtype == _JDT[jnp.dtype(s.dtype)], k
        assert got[k].empty().shape == tuple(s.shape)  # a meta tensor of that spec
    cfg = get_config(arch)
    assert specs.effective_config(cfg, SHAPES[shape_name]).sliding_window == (
        jspecs.effective_config(jget_config(arch), JSHAPES[shape_name]).sliding_window)
    if cfg.n_codebooks:  # audio tokens keep their codebook axis
        assert cfg.n_codebooks in got["tokens"].shape


def _axis_size(mesh, entry):
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b"])
def test_fsdp_fits_16gb_per_chip(arch):
    """tests/test_sharding.py's budget on the port's specs: bf16 params and
    fp32 m and v under fsdp on two pods, below 10 GB a chip, and the same
    bytes as the reference's specs give."""
    _, pt = _param_shapes(arch)
    per_dev = {}
    for name, spec_of in (("port", shd.param_spec), ("jax", jshd.param_spec)):
        per_dev[name] = sum(
            math.prod(shape) / math.prod(_axis_size(MULTI, e) for e in spec_of(path, shape, MULTI, "fsdp"))
            * (2 + 4 + 4) for path, shape in pt.items())
    assert per_dev["port"] == per_dev["jax"]
    assert per_dev["port"] < 10e9, f"{arch}: {per_dev['port'] / 1e9:.1f} GB/chip for params+opt"


def test_expert_leaves_shard_over_experts():
    _, pt = _param_shapes("qwen3_moe_235b_a22b")
    found = 0
    for path, shape in pt.items():
        if "'moe'" in path and "'wg'" in path:
            assert shd.param_spec(path, shape, SINGLE, "tp")[1] == "model", path  # (L, E, D, F): E
            found += 1
    assert found


def test_batch_and_cache_specs():
    assert shd.batch_spec((32, 8, 4096), SINGLE)[0] == "data"
    assert shd.batch_spec((32, 8, 4096), MULTI)[0] == ("pod", "data")
    assert "data" in shd.cache_spec((40, 1, 4096, 8, 128), 1, SINGLE)  # batch-1 decode
    sp = shd.cache_spec((36, 128, 32768, 8, 128), 128, SINGLE)
    assert sp[1] == "data" and "model" in sp
    assert tmesh.data_axes(MULTI) == ("pod", "data") and tmesh.data_size(MULTI) == 32
    assert tmesh.model_size(FakeMesh({"data": 4}, ("data",))) == 1


# ------------------------------------------------ on the fake process group
@pytest.fixture
def fake_world():
    import torch.distributed as dist

    yield tmesh.init_fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_extents(fake_world, multi_pod):
    fake_world(512 if multi_pod else 256)
    m = tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    assert tmesh.axis_sizes(m) == want and m.size() == math.prod(want.values())
    assert tmesh.data_size(m) == (32 if multi_pod else 16) and tmesh.model_size(m) == 16
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_production_mesh(multi_pod=not multi_pod, device_type="cpu")


@pytest.mark.parametrize("arch, policy", [("granite_3_2b", "tp"), ("qwen3_moe_235b_a22b", "fsdp"),
                                          ("xlstm_1_3b", "fsdp")])
def test_per_card_bytes_match_distributed_shards(fake_world, arch, policy):
    """Each leaf's DTensor placements (param_shardings) give, through
    ``distribute_tensor`` on fake tensors, exactly the local shape of its
    spec, and the local bytes add up to per_card_bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor

    fake_world(256)
    m = tmesh.make_production_mesh(device_type="cpu")
    shapes = build_model(get_config(arch)).init_shapes()
    places = dict(leaves_with_path(shd.param_shardings(shapes, m, policy)))
    total = 0
    with FakeTensorMode():
        for path, leaf in leaves_with_path(shapes):
            local = distribute_tensor(torch.empty(leaf.shape, dtype=leaf.dtype), m, places[path]).to_local()
            assert tuple(local.shape) == shd.local_shape(tuple(leaf.shape), shd.param_spec(
                path, tuple(leaf.shape), m, policy), m), path
            total += local.numel() * local.element_size()
    assert total == shd.per_card_bytes(shapes, m, policy)
    assert total < sum(a.numel() * a.element_size() for _, a in leaves_with_path(shapes))


def test_specs_become_dtensor_placements():
    """A spec entry names the mesh axes that shard its dim: ("pod", "data")
    on dim 0 is Shard(0) on both, in mesh order; an axis no entry names
    replicates."""
    from torch.distributed.tensor import Replicate, Shard

    assert shd.placements((("pod", "data"), None, "model"), MULTI) == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None, "data"), MULTI) == [Replicate(), Shard(1), Replicate()]
    assert shd.replicated(SINGLE) == [Replicate(), Replicate()]
    batch = {"tokens": specs.SDS((32, 8, 4096), torch.int32),
             "image_embeds": specs.SDS((32, 8, 1024, 1536), torch.bfloat16)}
    got = shd.batch_shardings(batch, MULTI, seq_shard=True)
    assert got["tokens"] == [Shard(0), Shard(0), Shard(2)]  # the sequence over model
    assert got["image_embeds"] == [Shard(0), Shard(0), Shard(2)]  # (..., P, D): P over model
    cache = {"k": torch.empty((36, 128, 32768, 8, 128), device="meta")}
    assert shd.cache_shardings(cache, 128, SINGLE)["k"] == [Shard(1), Shard(4)]
    assert shd.cache_shardings(cache, 128, SINGLE, seq_shard=True)["k"] == [Shard(1), Shard(2)]
