"""The per-card init (``Model.init_local``, ``launch.local``): one card's
blocks of the params drawn alone, against slices of the whole init, and the
whole init against the JAX package's, in one process.

A card of a (data, model) mesh holds a block of every leaf under the
reference's ``tp`` and ``fsdp`` policies (``sharding.param_shardings``);
its init draws only those elements, each from its own threefry counter, so
the blocks equal the whole init's, bit for bit, for every card. The draws
are bounded: a leaf is drawn ``rnd.CHUNK`` values at a time, and nothing
larger than a chunk is allocated besides the leaf itself.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import random as rnd
from repro_torch.launch import local
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshAxes
from repro_torch.models import build_model as tbuild
from repro_torch.models.common import deferred_draws, dense_init
from repro_torch.utils.tree import leaves_with_path

ARCHS = ["llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b", "granite-3-2b"]
OTHER_FAMILIES = ["zamba2-7b", "xlstm-1-3b", "musicgen-large", "qwen2-vl-2b"]
MESHES = [(1, 4), (2, 2), (4, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WHOLE = {}


def _whole(arch):
    """The reduced model and its whole init on the CPU (made once)."""
    if arch not in _WHOLE:
        model = tbuild(tconfigs.reduce_config(tconfigs.get_config(arch)))
        _WHOLE[arch] = model, model.init(rnd.key(0), device="cpu")
    return _WHOLE[arch]


def _mesh(shape):
    return MeshAxes(("data", "model"), {"data": shape[0], "model": shape[1]})


def _assert_every_card_equal(arch, mesh_shape, policy):
    model, full = _whole(arch)
    mesh = _mesh(mesh_shape)
    split = 0
    for coords in itertools.product(*map(range, mesh_shape)):
        shards = local.param_shards(full, mesh, policy, coords)
        mine = model.init_local(rnd.key(0), shards, device="cpu")
        for (path, a), (_, b), (_, s) in zip(leaves_with_path(mine), leaves_with_path(full),
                                             leaves_with_path(shards)):
            assert tuple(a.shape) == tuple(s.local_shape) and a.dtype == b.dtype, path
            assert torch.equal(a, b[s.slices()]), (arch, policy, coords, path)
            split += a.numel() < b.numel()
    assert split > 0  # the policy split some leaves on this mesh


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("policy", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_card_init_equals_its_slice_of_the_whole(arch, policy, mesh_shape):
    """Reduced llama4-maverick (dense/MoE pairs), qwen3-moe and granite:
    for every card of the mesh, its blocks drawn alone equal the slices of
    the whole init, bit for bit."""
    _assert_every_card_equal(arch, mesh_shape, policy)


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_card_init_equals_its_slice(arch):
    """The nested stacks (zamba2's superblocks and shared block, xlstm's
    groups), musicgen's per-codebook heads (a batch of keys) and the VLM
    projector, on a (2, 2) mesh under fsdp."""
    _assert_every_card_equal(arch, (2, 2), "fsdp")


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_init_still_equals_jax(monkeypatch, arch):
    """The whole init drawn in pieces of 4096 values (``rnd.CHUNK`` cut so
    that the reduced leaves, 2**17 values and more, take many pieces)
    equals the JAX package's (within the erfinv ulps of
    tests/test_torch_models.py)."""
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))))
    model, _ = _whole(arch)
    monkeypatch.setattr(rnd, "CHUNK", 4096)
    pieces = _count_pieces(monkeypatch)
    got = dict(leaves_with_path(model.init(rnd.key(0), device="cpu")))
    assert max(pieces) == 4096 and len(pieces) > 2 * len(got)  # leaves of many pieces
    assert got.keys() == want.keys()
    for k, a in got.items():
        np.testing.assert_allclose(a.numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)


def test_production_mesh_blocks_of_maverick():
    """llama4-maverick-400b-a17b at full width on the 16 x 16 mesh under
    fsdp (shapes only): card (0, 15) holds experts 120-127 of every layer's
    expert leaf, an F-slice of 512, and a card's blocks add up to
    ``sharding.per_card_bytes``."""
    model = tbuild(tconfigs.get_config("llama4-maverick-400b-a17b"))
    shapes = model.init_shapes()
    mesh = _mesh((16, 16))
    last = dict(leaves_with_path(local.param_shards(shapes, mesh, "fsdp", (0, 15))))
    s = last["['backbone']['moe_blocks']['moe']['wg']"]
    assert s.local_shape == (24, 8, 5120, 512) and s.offsets == (0, 120, 0, 0)
    blocks = local.param_shards(shapes, mesh, "fsdp", (3, 7))
    assert sum(np.prod(b.local_shape) * leaf.element_size()
               for (_, leaf), (_, b) in zip(leaves_with_path(shapes), leaves_with_path(blocks))
               ) == shd.per_card_bytes(shapes, mesh, "fsdp")


def _count_pieces(monkeypatch) -> list:
    """The sizes of the pieces the draws make, from now on."""
    sizes, orig = [], rnd._pieces

    def counted(*a, **k):
        for piece in orig(*a, **k):
            sizes.append(piece[1] - piece[0])
            yield piece

    monkeypatch.setattr(rnd, "_pieces", counted)
    return sizes


class _Largest(TorchDispatchMode):
    """The largest tensor an op allocates, the draw's output aside (views
    and in-place writes allocate nothing)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is not torch.ops.aten.empty.memory_format and not func.is_view:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and not any(t is a for a in args):
                    self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_init_of_a_leaf_64_chunks_stays_within_a_chunk(monkeypatch, dtype):
    """``dense_init`` of a leaf 64 times the chunk draws 64 pieces, none of
    its temporaries larger than a chunk, and equals the one-piece draw. The
    CPU allocator keeps no peak, so the pieces and the tensors the ops
    allocate are counted."""
    chunk = 4096
    shape = (64, 16, 256)
    key = rnd.key(9)
    whole = dense_init(key, shape, dtype)  # one piece: CHUNK is 2**24
    monkeypatch.setattr(rnd, "CHUNK", chunk)
    pieces = _count_pieces(monkeypatch)
    with _Largest() as mode:
        got = dense_init(key, shape, dtype)
    assert pieces == [chunk] * 64
    assert 0 < mode.largest <= chunk
    assert torch.equal(got, whole)
    # a card's block of it likewise, and equal to the block of the whole
    s = rnd.Shard((32, 8, 256), (32, 8, 0))
    with deferred_draws():
        draw = dense_init(key, shape, dtype)
    block = torch.empty(s.local_shape, dtype=dtype)
    with _Largest() as mode:
        draw.fill(block, s)
    assert mode.largest <= chunk and torch.equal(block, whole[s.slices()])
