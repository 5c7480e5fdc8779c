"""The sketch's projection kernel (``kernels/csrc/sketch_project.cu``): its
routes, work split and dry-run bytes on the CPU, and on the card its signs,
sums, repeatability and launch count against the plain version.

The plain version (``kernels/ref.py::sketch_project``) is the sketch's own
block-by-block path: each (block, d) Rademacher matrix drawn, then
multiplied. The kernel makes the same signs in registers; its sums run in
float32 in another order than cuBLAS's, so sums are held to a relative gap
of 1e-6 a row, and a one-hot row, whose sum is one sign, exactly.

JAX is imported inside the one test that compares with the JAX package, so
that the ``cuda`` tests run on a card whose machine has no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sketch_kernel.py``.
"""
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from repro_torch import random as rnd
from repro_torch.core import sketch
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import sketch_project as sp
from repro_torch.launch import dryrun
from repro_torch.utils import hlo, trace

# (n, d): one halved block, a whole block, blocks with a ragged last one
PLAIN_SHAPES = [(300, 8), (65536, 4), (2 * 65536 + 1000, 4)]


def _rows(R, n, seed=0, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(R, n, generator=g).to(dtype).to(device)


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("n, d", PLAIN_SHAPES)
def test_plain_version_is_the_sketch_block_by_block(n, d):
    flat, block = _rows(3, n), sketch._block_size(n)
    want = sketch.leaf_projection(flat, sketch.projection_blocks(n, d, 77, flat.device))
    assert torch.equal(ref.sketch_project(flat, block, d, 77), want)
    before = sp.launches
    assert torch.equal(ops.sketch_project(flat, block, d, 77), want)  # the CPU route: the plain version
    assert sp.launches == before


def test_a_fake_tensor_gets_the_output_allocation_and_no_launch(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a fake tensor reached a launch or the plain version")

    monkeypatch.setattr(ref, "sketch_project", boom)
    monkeypatch.setattr(build, "launch", boom)
    monkeypatch.setattr(build, "library", boom)
    before = sp.launches
    with FakeTensorMode():
        flat = torch.empty(5, 3 * 65536 + 7)
        out = ops.sketch_project(flat, 65536, 128, 3)
        half = ops.sketch_project(flat.bfloat16(), 65536, 32, 3)
    assert is_fake(out) and tuple(out.shape) == (5, 128) and out.dtype == torch.float32
    assert tuple(half.shape) == (5, 32) and half.dtype == torch.float32
    assert sp.launches == before


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        sp.sketch_project(torch.zeros(2, 300), 512, 8, 0)  # a CPU tensor
    with FakeTensorMode():
        x = torch.empty(2, 300)
        with pytest.raises(TypeError):
            sp.sketch_project(x.double(), 512, 8, 0)
        with pytest.raises(ValueError):
            sp.sketch_project(torch.empty(300, 2).t(), 512, 8, 0)  # rows not contiguous
        with pytest.raises(ValueError):
            sp.sketch_project(x, 100, 8, 0)  # not a power-of-two block
        with pytest.raises(ValueError):
            ops.sketch_project(x, 1 << 17, 8, 0)  # a block past 2**16


def _leaves(R, big_n, small_n):
    """A stacked backbone leaf whose last block has ``big_n`` values and a
    final norm of ``small_n``."""
    return {"backbone": {"w": torch.randn(R, 2, big_n)}, "final_norm": {"scale": torch.randn(R, small_n)}}


@pytest.mark.parametrize("fake", [False, True])
def test_only_leaves_too_large_to_keep_take_the_kernels_route(monkeypatch, fake):
    """A leaf whose matrices are not kept goes to ``ops.sketch_project``, on
    the card (a fake tensor here: no launch) and on the CPU (the plain
    version, no launch); a kept leaf never does."""
    monkeypatch.setattr(sketch, "CACHE_FLOATS", 1 << 16)
    seen = []
    orig = ops.sketch_project

    def spy(flat, block, d, seed):
        seen.append((tuple(flat.shape), block, d, seed))
        return orig(flat, block, d, seed)

    monkeypatch.setattr(ops, "sketch_project", spy)
    sk = sketch.GradientSketcher(d_sketch=16, strategy="last_block_proj", seed=5)
    big, small = 70000, 300  # 2 blocks x 65536 x 16 floats, not kept; 512 x 16, kept
    before = sp.launches
    if fake:
        with FakeTensorMode():
            out = sk.batch(_leaves(2, big, small))
        assert is_fake(out)
    else:
        out = sk.batch(_leaves(2, big, small))
    assert tuple(out.shape) == (2, 16) and sp.launches == before
    # leaves in JAX's order: backbone/w is leaf 0
    assert seen == [((2, big), 65536, 16, 5 * 7919 + 0)]
    assert all(len(m) for m in sk._blocks.values()) and {k[0] for k in sk._blocks} == {small}


def test_last_block_sketch_on_the_cpu_still_matches_jax(monkeypatch):
    """Leaves too large to keep are drawn block by block on the CPU, as the
    JAX package draws them: the sketches agree."""
    import jax
    import jax.numpy as jnp

    from repro.core.sketch import GradientSketcher as JSketcher

    monkeypatch.setattr(sketch, "CACHE_FLOATS", 1 << 16)
    rng = np.random.default_rng(1)
    deltas = {"backbone": {"w": (0.01 * rng.standard_normal((3, 2, 70000))).astype(np.float32)},
              "final_norm": {"scale": (0.01 * rng.standard_normal((3, 300))).astype(np.float32)}}
    kw = dict(d_sketch=16, strategy="last_block_proj")
    want = np.asarray(jax.vmap(JSketcher(**kw))(jax.tree_util.tree_map(jnp.asarray, deltas)))
    with trace.recording() as spans:
        got = sketch.GradientSketcher(**kw).batch(
            {"backbone": {"w": torch.from_numpy(deltas["backbone"]["w"])},
             "final_norm": {"scale": torch.from_numpy(deltas["final_norm"]["scale"])}})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    names = [s.name for s in spans]
    assert "kernels.sketch_project" not in names and names.count("sketch.draw") == 2 + 1


@pytest.mark.parametrize("n, block, chunk, ctas", [
    (16_777_216, 65536, 8192, 2048),  # granite's wg, wu, wd
    (4_194_304, 65536, 4096, 1024),  # wq, wo
    (1_048_576, 65536, 1024, 1024),  # wk, wv
    (65536, 65536, 256, 256),
    (300, 512, 256, 2),
    (100, 128, 128, 1),
])
def test_chunks_divide_the_block_and_fill_the_card(n, block, chunk, ctas):
    assert sketch._block_size(n) == block
    assert sp.chunk_rows(n, block) == chunk and sp.partials(n, block) == ctas
    assert block % chunk == 0


def test_dry_run_counts_the_kernels_bytes():
    """Under the dry run's counter a fake leaf that takes the kernel adds
    the call's bytes: its rows read once, the partials written and read, the
    output written."""
    R, n, d = 2, 3 * 65536 + 5, 128
    counter = hlo.StepCounter()
    with FakeTensorMode():
        flat = torch.empty(R, n)
        with dryrun._sketch_kernel_bytes(counter), counter:
            ops.sketch_project(flat, 65536, d, 1)
    chunks = -(-n // 256)  # the smallest chunk: fewer than 1024 CTAs at any larger one
    assert sp.partials(n, 65536) == chunks
    assert counter.bytes_accessed == R * n * 4 + 2 * chunks * R * d * 4 + R * d * 4
    assert counter.flops == 2 * R * n * d


def test_projection_rows_take_their_counters_high_word():
    """``random.rademacher_rows`` is the plain draw's rows also where a
    block's counters pass 2**32 (d 65537 on a block of 65536 rows)."""
    block, d = 65536, 65537
    k = rnd.key(9)
    rows = rnd.rademacher_rows(k, block, torch.tensor([3, 65535, 65536 + 65535]), d)
    for row, g in zip(rows, (3, 65535, 65536 + 65535)):
        b = rnd.bits(rnd.fold_in(k, g // block), (block, d), shard=rnd.Shard((1, d), (g % block, 0)))
        assert torch.equal(row, (1 - 2 * (b >> 31)).float().reshape(d))


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gap(got, want):
    """Relative L2 gap of each row."""
    return (torch.linalg.vector_norm((got - want).double(), dim=1)
            / torch.linalg.vector_norm(want.double(), dim=1)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, at", [
    (3 * 65536 + 1000, 128, (0, 65535, 65536, 131071, 131072, 3 * 65536, 3 * 65536 + 999)),  # ragged
    (1000, 128, (0, 1, 511, 999)),  # one halved block (1024 rows)
    (70000, 300, (0, 255, 65535, 65536, 69999)),  # two column tiles, the second ragged
    (5000, 17, (0, 16, 4999)),  # row lanes that cut across warps
])
def test_one_hot_rows_give_the_plain_signs_exactly(cuda, n, d, at):
    flat = torch.zeros(len(at), n, device=cuda)
    flat[torch.arange(len(at)), torch.tensor(at)] = 1.0
    got = ops.sketch_project(flat, sketch._block_size(n), d, 2024)
    want = ref.sketch_project(flat, sketch._block_size(n), d, 2024)
    assert torch.equal(got, want)
    rows = rnd.rademacher_rows(rnd.key(2024, device=cuda), sketch._block_size(n),
                               torch.tensor(at, device=cuda), d)
    assert torch.equal(got, rows / math.sqrt(n))


@pytest.mark.cuda
def test_counters_past_32_bits_take_their_high_word(cuda):
    """d 65537 on a block of 65536 rows: the last rows' counters pass 2**32."""
    n, d, at = 65536, 65537, (0, 65535)
    flat = torch.zeros(len(at), n, device=cuda)
    flat[torch.arange(len(at)), torch.tensor(at)] = 1.0
    got = ops.sketch_project(flat, 65536, d, 9)
    rows = rnd.rademacher_rows(rnd.key(9, device=cuda), 65536, torch.tensor(at, device=cuda), d)
    assert torch.equal(got, rows / math.sqrt(n))


@pytest.mark.cuda
@pytest.mark.parametrize("R, n, d, dtype", [
    (2, 4_194_304, 128, torch.float32),
    (2, 1_048_576, 128, torch.float32),
    (2, 16_777_216, 128, torch.float32),
    (1, 1_048_576, 128, torch.float32),
    (3, 1_048_576, 32, torch.float32),
    (17, 1_048_576, 256, torch.float32),
    (2, 1_048_576, 128, torch.bfloat16),
])
def test_sums_hold_to_the_plain_version(cuda, R, n, d, dtype):
    flat = _rows(R, n, seed=n + R, dtype=dtype, device=cuda)
    got = ops.sketch_project(flat, 65536, d, 11)
    want = ref.sketch_project(flat, 65536, d, 11)
    assert _gap(got, want) <= 1e-6


@pytest.mark.cuda
def test_a_last_block_slice_is_read_in_place(cuda):
    """``leaf[:, -1]`` of a stacked (R, L, a, b) leaf: rows a stride apart."""
    leaf = _rows(2, 3 * 1024 * 1024, seed=4, device=cuda).reshape(2, 3, 1024, 1024)
    flat = leaf[:, -1].reshape(2, -1)
    assert flat.stride() == (3 * 1024 * 1024, 1)
    got = ops.sketch_project(flat, 65536, 128, 6)
    assert _gap(got, ref.sketch_project(flat.contiguous(), 65536, 128, 6)) <= 1e-6


@pytest.mark.cuda
def test_two_launches_are_bit_equal_and_counted(cuda):
    flat = _rows(17, 1_048_576, seed=8, device=cuda)
    before = sp.launches
    a = ops.sketch_project(flat, 65536, 128, 3)
    b = ops.sketch_project(flat, 65536, 128, 3)
    assert torch.equal(a, b)
    assert sp.launches == before + 2 * 3  # two passes of rows and the reduction, twice
    ops.sketch_project(flat[:2], 65536, 128, 3)
    assert sp.launches == before + 2 * 3 + 2


@pytest.mark.cuda
def test_the_sketcher_takes_the_kernel_for_large_leaves_on_the_card(cuda):
    """granite-like leaves: the large last-block leaf through one kernel span
    a call, the kept leaf's blocks drawn once; the sketch against the CPU's."""
    R = 2
    upd = {"backbone": {"w": _rows(R, 2 * 4_194_304, seed=3).reshape(R, 2, 2048, 2048)},
           "final_norm": {"scale": _rows(R, 2048, seed=5)}}
    sk = sketch.GradientSketcher(d_sketch=128, strategy="last_block_proj")
    on_card = {"backbone": {"w": upd["backbone"]["w"].to(cuda)},
               "final_norm": {"scale": upd["final_norm"]["scale"].to(cuda)}}
    # the plain version of each leaf, in JAX's leaf order
    want = (ref.sketch_project(on_card["backbone"]["w"][:, -1].reshape(R, -1), 65536, 128, sk.seed * 7919)
            + ref.sketch_project(on_card["final_norm"]["scale"], 2048, 128, sk.seed * 7919 + 1))
    for i in range(2):
        with trace.recording() as spans:
            got = sk.batch(on_card)
        names = [s.name for s in spans]
        assert names.count("kernels.sketch_project") == 1
        assert names.count("sketch.draw") == (1 if i == 0 else 0)
        kern = next(s for s in spans if s.name == "kernels.sketch_project")
        assert kern.meta == {"rows": R, "n": 4_194_304, "d": 128, "blocks": 64}
    assert _gap(got, want) <= 1e-6
