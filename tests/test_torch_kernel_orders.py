"""The summation orders of the port's segment-sum and cosine kernels
(``kernels/csrc/segment_aggregate.cu``, ``kernels/csrc/cosine_sim.cu``),
emulated in plain PyTorch on the CPU and held against the JAX package's
Pallas kernels (interpret mode on the CPU, as the JAX kernel tests run
them).

The CUDA kernels cannot run here; these emulations repeat what each one
adds to what, and in which order, so that a change of order that leaves
the JAX tolerances is caught on the CPU:
  - segment sum: each block of the plan (``segment_aggregate.plan``) owns
    one segment and a span of column vectors, lists the segment's rows in
    row order (a chunk of ``CHUNK`` rows at a time) and adds each row onto
    the segment's running sum, +0 before the first chunk, the value the
    earlier chunks stored after it. That is the plain version's
    order (``index_add_``), so the emulation is held bit-equal to it
    wherever a segment's rows sit. The planner's own tests replay its
    mapping of blocks and threads to (segment, vector) pairs: every output
    element has one owner, the grid reaches two waves of 132 SMs where the
    work allows, and the main-path and LM calls get the spans PERF.md
    describes;
  - cosine, K <= 8: per-lane partials of |x|^2, the dots and the
    centroid norms over 16-byte vectors of D, reduced by a butterfly over
    the 32 lanes (the interleaved reduction gives each slot that order);
    K > 8 in f32: FMA over 4 k-groups of 8 columns of each 32-wide tile,
    added in order, the norms in two halves of each tile; K >= 8 in bf16:
    tensor-core k16 steps, k-group g taking step g of each 64-wide tile,
    accumulated in f32, the norms in two halves of each tile.
Tolerances are the JAX kernel tests' own: 2e-5 in f32; 2e-2 (cosine) and
5e-2 (segment) in bf16.

The tests marked ``cuda`` hold the kernels themselves against the plain
versions on the card (they skip without one):
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_orders.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_aggregate as sa

SHAPES = [(1, 128, 2), (7, 33, 3), (128, 512, 8), (200, 300, 5), (1024, 256, 16), (64, 64, 64)]
SEG_SHAPES = SHAPES + [(125, 6922, 7), (125, 6922, 63), (125, 6922, 127), (125, 1, 7),
                       (300, 1, 63), (37, 5, 4), (0, 128, 2), (0, 1, 3), (600, 40, 400)]
COS_SHAPES = SHAPES + [(64, 128, 2), (33, 128, 1), (40, 130, 9), (300, 64, 7)]
TOL_COS = {"f32": 2e-5, "bf16": 2e-2}
TOL_SEG = {"f32": 2e-5, "bf16": 5e-2}
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SMS = 132  # an H100's SMs: the plans below are the card's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_ops():
    """(repro.kernels.ops, jax.numpy) of the JAX package."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    return jops, jnp


def _inputs(jnp, rng, shape, dname):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dname]
    jx = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TORCH_DTYPES[dname])


# ------------------------------------------------------------ segment sum
def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (32 lanes) as the xor butterfly 16, 8, 4, 2, 1."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., torch.arange(32) ^ o]
    return v[..., 0]


def emulate_segment(x, ids, K, w=None, sms=SMS, chunk=None):
    """One cohort (x (P, D), ids (P,)) in the kernel's order, as f32: each
    segment's block lists its rows a chunk at a time, in row order, and
    each row is added onto the segment's running sum (+0 before the first
    chunk, the value the earlier chunks stored after it); other ids are
    dropped. A block's column span changes no sum, so the emulation sums
    whole rows."""
    x = x.float()
    P, D = x.shape
    w = torch.ones(P) if w is None else w.float()
    chunk = chunk or sa.plan(1, P, D, K, 4, sms).chunk
    key = ids.long().tolist()
    out = torch.zeros(K, D)
    for k in range(K):
        for p0 in range(0, P, chunk):
            for p in range(p0, min(P, p0 + chunk)):  # the chunk's list: the segment's rows in order
                if key[p] == k:
                    out[k] = out[k] + w[p] * x[p]  # the product rounded first, as __fmul_rn
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", SEG_SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_order_matches_jax(jax_ops, shape, dname, weighted):
    jops, jnp = jax_ops
    P, D, K = shape
    rng = np.random.default_rng(P * 7 + D + K)
    jx, tx = _inputs(jnp, rng, (P, D), dname)
    ids = rng.integers(-1, K + 1, P).astype(np.int32)  # -1 and K are dropped
    w = rng.random(P).astype(np.float32) if weighted else None
    if P:
        want = np.asarray(
            jops.segment_aggregate(jx, jnp.asarray(ids), K, None if w is None else jnp.asarray(w))
        )
    else:  # the JAX kernel takes no empty input; zero rows sum to zeros
        want = np.zeros((K, D), np.float32)
    got = emulate_segment(tx, torch.from_numpy(ids), K, None if w is None else torch.from_numpy(w))
    tol = TOL_SEG[dname]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("P, D, K, chunk", [(1024, 64, 16, 256), (2000, 8, 5, 300), (700, 48, 3, 64),
                                            (5000, 3, 1, sa.CHUNK)])
def test_segment_chunks_continue_in_row_order(P, D, K, chunk):
    """Past a chunk of rows each chunk continues the sums the earlier ones
    stored: the plain version's bits."""
    assert P > chunk
    g = torch.Generator().manual_seed(P + D)
    x = torch.randn(P, D, generator=g)
    ids = torch.randint(-1, K + 1, (P,), generator=g)
    w = torch.rand(P, generator=g)
    got = emulate_segment(x, ids, K, w, chunk=chunk)
    assert torch.equal(_bits(got), _bits(ref.segment_aggregate(x, ids, K, w)))


def _owners(C, P, D, K, el, address=0):
    """Replays the kernel's mapping of blocks to (segment, vector) pairs
    (block x of a cohort: segment x // nspan, vectors [v0, v0 + span) of
    span x % nspan; vector j of the span is thread j % threads's, whatever
    the chunk): the number of times each output element (C, K, D) is
    owned, and the plan."""
    pl = sa.plan(C, P, D, K, el, SMS, address)
    E = pl.vec_bytes // el
    nv = D // E
    hits = np.zeros((C, K, D), np.int64)
    for x in range(K * pl.nspan):
        s, sp = divmod(x, pl.nspan)
        v = np.arange(sp * pl.span, min(nv, (sp + 1) * pl.span))
        for e in range(E):
            np.add.at(hits, (slice(None), s, v * E + e), 1)
    return hits, pl


@pytest.mark.parametrize("C, P, D, K, el, address", [(1, 125, 6922, 7, 4, 0), (1, 125, 1, 7, 4, 0),
                                                     (4, 64, 128, 2, 4, 0), (3, 600, 40, 400, 4, 0),
                                                     (1, 8192, 512, 32, 2, 0), (2, 37, 7, 5, 2, 6)])
def test_segment_plan_owns_every_output_once(C, P, D, K, el, address):
    """Every (cohort, segment, column) has exactly one owning block and
    thread, so no segment's rows are split between owners; a chunk never
    passes CHUNK rows."""
    hits, pl = _owners(C, P, D, K, el, address)
    assert (hits == 1).all()
    assert pl.threads % 32 == 0 and pl.threads <= 256 and pl.rows in (2, 8, 32)
    assert 1 <= pl.chunk <= sa.CHUNK and pl.chunk == max(1, min(P, sa.CHUNK))


@pytest.mark.parametrize("C, D, K, el", [(1, 6922, 63, 4), (1, 512, 32, 4), (1, 4096, 4, 2),
                                         (16, 6922, 8, 4), (1, 1, 5000, 4), (1, 41_943_040, 1, 4)])
def test_segment_grid_fills_two_waves(C, D, K, el):
    """Where the pairs give every block of two waves at least a warp's
    worth, the grid has two waves of 132 SMs; it passes WAVES blocks an SM
    only where the segments (a block each at least) do."""
    pl = sa.plan(C, 100, D, K, el, SMS)
    pairs = C * K * (D * el // pl.vec_bytes)
    blocks = C * K * pl.nspan
    assert blocks >= min(2 * SMS, pairs // sa.MIN_PAIRS)
    assert blocks <= max(sa.WAVES * SMS, C * K)
    if pairs >= 2 * SMS * pl.threads:
        assert blocks >= 2 * SMS


@pytest.mark.parametrize("call, want", [
    # stage 2: 4-byte vectors (rows of 27,688 bytes take 8, too few pairs),
    # 55 spans of one segment's 6922 columns, 8 of its ~18 rows in flight
    ((1, 125, 6922, 7), dict(vec_bytes=4, rows=8, threads=128, span=126, nspan=55)),
    # its D = 1 denominator: a block a segment, a grid under a wave: 256
    # threads, 32 rows in flight
    ((1, 125, 1, 7), dict(vec_bytes=4, rows=32, threads=256, span=1, nspan=1)),
    # the clustering sums: 4 spans of 32 columns of one segment
    ((4, 64, 128, 2), dict(vec_bytes=4, rows=32, threads=256, span=32, nspan=4)),
    # the LM leaves: 1056 blocks (8 an SM) of ~0.64M columns, 16-byte vectors
    ((1, 2, 671_088_640, 1), dict(vec_bytes=16, rows=2, threads=256, span=158_876, nspan=1056)),
    ((1, 2, 704_643_072, 1), dict(vec_bytes=16, rows=2, threads=256, span=166_819, nspan=1056)),
])
def test_segment_plan_of_the_main_and_lm_calls(call, want):
    C, P, D, K = call
    pl = sa.plan(C, P, D, K, 4, SMS)
    assert {k: getattr(pl, k) for k in want} == want
    assert pl.chunk == P


@pytest.mark.parametrize("D, el, address, want", [(6922, 4, 0, 8), (6922, 2, 0, 4), (6923, 2, 0, 2),
                                                  (512, 4, 4, 4), (1, 4, 0, 4), (8, 2, 8, 8)])
def test_segment_vector_divides_every_row(D, el, address, want):
    """The widest vector divides a row's bytes and the data's address, so
    no row has a ragged start or tail; the plan narrows it no further than
    4 bytes, or one bf16 where the rows force it."""
    assert sa.vector_bytes(D, el, address) == want
    pl = sa.plan(1, 10, D, 3, el, SMS, address)
    assert (D * el) % pl.vec_bytes == 0 and address % pl.vec_bytes == 0
    assert pl.vec_bytes >= min(4, want)


# one segment's 25 rows placed across a call: (C, P, block, first row).
# Offsets 0 and 37, blocks 1 and 3 of a stacked call, and rows that
# straddle the chunk boundaries at 256, 512 and 1024 (and 512 in block 3)
PLACEMENTS = {"row0": (1, 75, 0, 0), "row37": (1, 75, 0, 37), "block1": (2, 75, 1, 11),
              "block3": (4, 75, 3, 50), "straddle256": (1, 500, 0, 240),
              "straddle512": (1, 600, 0, 500), "straddle1024": (1, 2000, 0, 1020),
              "block3_straddle512": (4, 600, 3, 500)}
LAYOUT_K, LAYOUT_ROWS = 5, 25


def _placed(seg, wseg, C, P, blk, off, seed):
    """A (C, P, D) call whose segment 0 holds exactly ``seg``'s rows at
    [off, off + 25) of block ``blk``; the other rows belong to segments
    1..K-1 or are dropped (-1)."""
    g = torch.Generator().manual_seed(seed)
    D = seg.shape[1]
    data = torch.randn(C, P, D, generator=g).to(seg.dtype)
    ids = torch.randint(-1, LAYOUT_K, (C, P), generator=g)
    ids[ids == 0] = 1
    w = torch.rand(C, P, generator=g)
    data[blk, off:off + LAYOUT_ROWS] = seg
    ids[blk, off:off + LAYOUT_ROWS] = 0
    w[blk, off:off + LAYOUT_ROWS] = wseg
    return data, ids, w


@pytest.mark.parametrize("where", list(PLACEMENTS))
@pytest.mark.parametrize("D", [1, 7, 6922])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_row_order_is_layout_free(where, D, dname, weighted):
    """The kernel's order gives the plain version's bits (``torch.equal`` on
    the int32 views) on the whole call, and segment 0's sum has the same
    bits wherever its rows sit."""
    g = torch.Generator().manual_seed(D)
    seg = torch.randn(LAYOUT_ROWS, D, generator=g).to(TORCH_DTYPES[dname])
    wseg = torch.rand(LAYOUT_ROWS, generator=g)
    C, P, blk, off = PLACEMENTS[where]
    data, ids, w = _placed(seg, wseg, C, P, blk, off, seed=P + off)
    wt = w if weighted else None
    plain = ref.segment_aggregate(data, ids, LAYOUT_K, wt)
    got = torch.stack([emulate_segment(data[c], ids[c], LAYOUT_K, None if wt is None else wt[c])
                       for c in range(C)])
    assert torch.equal(_bits(got), _bits(plain))
    alone = ref.segment_aggregate(seg, torch.zeros(LAYOUT_ROWS, dtype=torch.long), 1,
                                  wseg if weighted else None)[0]
    assert torch.equal(_bits(got[blk, 0]), _bits(alone))


@pytest.mark.parametrize("shape", [(80, 130, 8), (300, 1, 63), (125, 6922, 63), (600, 40, 3)])
def test_segment_invariants(shape):
    """The JAX kernel tests' invariants on the kernel's order: mass is
    conserved, and zero weights give zeros."""
    P, D, K = shape
    g = torch.Generator().manual_seed(P)
    x = torch.randn(P, D, generator=g)
    ids = torch.randint(0, K, (P,), generator=g)
    np.testing.assert_allclose(emulate_segment(x, ids, K).sum(0).numpy(), x.sum(0).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert not emulate_segment(x, ids, K, torch.zeros(P)).any()


# ------------------------------------------------------------ cosine
def _lane_sums(prod: torch.Tensor, vec: int) -> torch.Tensor:
    """prod (..., D): each lane's sequential sum of its elements (element d
    belongs to lane (d // vec) % 32), in increasing d -> (..., 32)."""
    D = prod.shape[-1]
    Dp = math.ceil(D / (32 * vec)) * 32 * vec
    p = torch.nn.functional.pad(prod, (0, Dp - D)).reshape(*prod.shape[:-1], Dp // (32 * vec), 32, vec)
    acc = torch.zeros(*prod.shape[:-1], 32)
    for j in range(p.shape[-3]):
        for e in range(vec):
            acc = acc + p[..., j, :, e]
    return acc


def _seq(prod: torch.Tensor, idx) -> torch.Tensor:
    """Sequential sum over the positions idx of the last axis."""
    acc = torch.zeros(prod.shape[:-1])
    for d in idx:
        acc = acc + prod[..., d]
    return acc


def emulate_cosine(x, c, eps=1e-8):
    """One cohort (x (P, D), c (K, D)) in the kernel's order, as f32."""
    bf16 = x.dtype == torch.bfloat16
    P, D = x.shape
    K = c.shape[0]
    x, c = x.float(), c.float()
    el = 2 if bf16 else 4
    if K < 8 or (K == 8 and not bf16):  # rows kernel
        vec = 16 // el if (D * el) % 16 == 0 else 1
        x2 = _butterfly(_lane_sums(x * x, vec))
        dots = _butterfly(_lane_sums(x[:, None, :] * c[None], vec))
        c2 = _butterfly(_lane_sums(c * c, vec))  # the same lanes as x
        return dots / torch.clamp(torch.sqrt(x2[:, None] * c2[None]), min=eps)
    # four k-groups split each D tile; each sums its share over the tiles
    # in order, and the four sums are added in k-group order
    if not bf16:  # f32 register tile, 8 columns of each 32-wide tile a k-group
        tile = 32
        prod = x[:, None, :] * c[None]
        parts = [_seq(prod, [d for d in range(D) if (d % 32) // 8 == g]) for g in range(4)]
    else:  # tensor cores: k16 step g of each 64-wide tile, accumulated in f32
        tile = 64
        prod = torch.nn.functional.pad(x[:, None, :] * c[None], (0, (-D) % 16))
        blocks = prod.reshape(P, K, -1, 16).sum(-1)
        parts = [_seq(blocks, range(g, blocks.shape[-1], 4)) for g in range(4)]
    dots = ((parts[0] + parts[1]) + parts[2]) + parts[3]

    def split_sum(v):  # the two halves of each tile, each sequential over tiles, then added
        halves = [_seq(v, [d for d in range(D) if (d % tile) < tile // 2]),
                  _seq(v, [d for d in range(D) if (d % tile) >= tile // 2])]
        return halves[0] + halves[1]

    x2, c2 = split_sum(x * x), split_sum(c * c)
    return dots / torch.clamp(torch.sqrt(x2[:, None] * c2[None]), min=eps)


@pytest.mark.parametrize("shape", COS_SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_cosine_order_matches_jax(jax_ops, shape, dname):
    jops, jnp = jax_ops
    P, D, K = shape
    rng = np.random.default_rng(P * 1000 + D + K)
    jx, tx = _inputs(jnp, rng, (P, D), dname)
    jc, tc = _inputs(jnp, rng, (K, D), dname)
    if P > 1:  # a zero row gives similarity 0
        tx[0] = 0
        jx = jx.at[0].set(0)
    want = np.asarray(jops.cosine_similarity(jx, jc))
    got = emulate_cosine(tx, tc)
    tol = TOL_COS[dname]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    if P > 1:
        assert not got[0].any()


@pytest.mark.parametrize("shape", [(97, 200, 9), (64, 128, 2), (33, 64, 32), (50, 7, 5)])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_cosine_invariants(shape, dname):
    """The JAX kernel tests' invariants on the kernel's order: values in
    [-1, 1], unchanged when x is scaled (3.7 keeps bf16 inputs exact only
    in f32, so bf16 scales by 4)."""
    P, D, K = shape
    g = torch.Generator().manual_seed(D)
    dt = TORCH_DTYPES[dname]
    x, c = torch.randn(P, D, generator=g).to(dt), torch.randn(K, D, generator=g).to(dt)
    got = emulate_cosine(x, c)
    assert (got <= 1 + 1e-4).all() and (got >= -1 - 1e-4).all()
    scale = 3.7 if dname == "f32" else 4.0
    np.testing.assert_allclose(emulate_cosine((x.float() * scale).to(dt), c).numpy(), got.numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU run covers the kernels' orders")
    return torch.device("cuda")


CUDA_SHAPES = [(125, 6922, 7), (125, 6922, 63), (125, 6922, 127), (1024, 256, 8),
               (4096, 256, 16), (8192, 512, 32), (300, 1, 63), (125, 1, 7), (300, 6922, 7),
               (600, 40, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
def test_cuda_kernels_match_plain_new_shapes(cuda, shape, dtype, id_dtype):
    from repro_torch.kernels import cosine_sim

    P, D, K = shape
    g = torch.Generator(device=cuda).manual_seed(P + D + K)
    x = torch.randn(2, P, D, generator=g, device=cuda).to(dtype)
    c = torch.randn(2, K, D, generator=g, device=cuda).to(dtype)
    ids = torch.randint(-1, K + 1, (2, P), generator=g, device=cuda)
    w = torch.rand(2, P, generator=g, device=cuda)
    n_cos, n_seg = cosine_sim.launches, sa.launches
    tc, ts = (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 5e-2)
    torch.testing.assert_close(ops.cosine_similarity(x, c), ref.cosine_similarity(x, c), rtol=tc, atol=tc)
    for wt in (None, w):
        got = ops.segment_aggregate(x, ids.to(id_dtype), K, wt)
        torch.testing.assert_close(got, ref.segment_aggregate(x, ids, K, wt), rtol=ts, atol=ts)
    assert cosine_sim.launches == n_cos + 1 and sa.launches == n_seg + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(125, 6922, 63), (8192, 512, 32), (300, 1, 63)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_bit_identical(cuda, shape, dtype):
    P, D, K = shape
    g = torch.Generator(device=cuda).manual_seed(K)
    x = torch.randn(P, D, generator=g, device=cuda).to(dtype)
    c = torch.randn(K, D, generator=g, device=cuda).to(dtype)
    ids = torch.randint(0, K, (P,), generator=g, device=cuda)
    w = torch.rand(P, generator=g, device=cuda)
    assert torch.equal(ops.segment_aggregate(x, ids, K, w), ops.segment_aggregate(x, ids, K, w))
    assert torch.equal(ops.cosine_similarity(x, c), ops.cosine_similarity(x, c))
