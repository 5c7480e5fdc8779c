"""The port's threefry (repro_torch.random) against jax.random.

Raw bits, split, fold_in, uniform and rademacher must be BIT-equal: the
port reproduces the JAX package's draws (model init, sketch projections,
k-means seeding, training keys) draw for draw. normal / truncated_normal
go through erfinv, whose float32 implementations differ by a few ulp
between XLA and torch; categorical must pick the same indices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as trnd

# fixed at import: parametrize ids must be the same in every xdist worker
# seeds past 32 bits: jax (64-bit mode off) keeps the low 32 bits
SEEDS = [0, 1, 42, 1234 * 7919, 2**31 - 1, 5287, 2**32, 2**40 + 5, -(2**31) - 1, 2**63 - 1]
SHAPES = [(1,), (7,), (3, 5), (128, 16), (2, 3, 4)]


def _jkey_words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("lo, hi", [(0, 1024), (0, 7), (-5, 70_001), (3, 3), (9, 2), (-2**31, 2**31 - 1),
                                     (0, 2**31 - 1)])
def test_randint_bit_equal(lo, hi):
    """Spans below and past 2**16 (the uint32 product wraps), one that is
    not a power of 2, an empty range (minval), and int32's whole range."""
    for seed in (0, 42):
        jk, tk = jax.random.fold_in(jax.random.key(seed), 3), trnd.fold_in(trnd.key(seed), 3)
        want = np.asarray(jax.random.randint(jk, (8, 33), lo, hi))
        got = trnd.randint(tk, (8, 33), lo, hi)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bit_equal(seed):
    jk = jax.random.key(seed)
    tk = trnd.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _jkey_words(jk))
    for num in (2, 3, 125):
        np.testing.assert_array_equal(
            trnd.split(tk, num).numpy(), _jkey_words(jax.random.split(jk, num))
        )
    for data in (0, 1, 17, 2**20 + 3):
        np.testing.assert_array_equal(
            trnd.fold_in(tk, data).numpy(),
            _jkey_words(jax.random.fold_in(jk, data)),
        )
    # fold_in takes uint32 data only; jax raises outside it, and so does the port
    for data in (2**32 - 1, 2**31):
        np.testing.assert_array_equal(
            trnd.fold_in(tk, data).numpy(),
            _jkey_words(jax.random.fold_in(jk, data)),
        )
    for data in (2**32, -1, -(2**31), 2**63):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jk, data)
        with pytest.raises(OverflowError):
            trnd.fold_in(tk, data)
    # chained derivations stay equal
    a, b = jax.random.split(jax.random.fold_in(jk, 5))
    ta, tb = trnd.split(trnd.fold_in(tk, 5))
    np.testing.assert_array_equal(tb.numpy(), _jkey_words(b))
    np.testing.assert_array_equal(ta.numpy(), _jkey_words(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_uniform_rademacher_bit_equal(seed, shape):
    jk, tk = jax.random.key(seed), trnd.key(seed)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(trnd.bits(tk, shape).numpy(), want)
    u = np.asarray(jax.random.uniform(jk, shape))
    np.testing.assert_array_equal(trnd.uniform(tk, shape).numpy(), u)
    r = np.asarray(jax.random.rademacher(jk, shape, jnp.float32))
    np.testing.assert_array_equal(trnd.rademacher(tk, shape).numpy(), r)


def test_batched_keys_match_per_key_draws():
    jks = jax.random.split(jax.random.key(3), 6)
    tks = trnd.split(trnd.key(3), 6)
    got = trnd.uniform(tks, (4, 5)).numpy()
    want = np.stack([np.asarray(jax.random.uniform(k, (4, 5))) for k in jks])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_and_truncated_normal_within_ulps(seed):
    jk, tk = jax.random.key(seed), trnd.key(seed)
    shape = (64, 32)
    n = np.asarray(jax.random.normal(jk, shape))
    np.testing.assert_allclose(trnd.normal(tk, shape).numpy(), n, rtol=4e-6, atol=4e-6)
    t = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape, jnp.float32))
    got = trnd.truncated_normal(tk, -2.0, 2.0, shape).numpy()
    np.testing.assert_allclose(got, t, rtol=4e-6, atol=4e-6)
    assert got.min() > -2.0 and got.max() < 2.0


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_same_indices(seed):
    rng = np.random.default_rng(seed % 2**32)
    logits = np.log(np.maximum(rng.random(50).astype(np.float32), 1e-9))
    jk, tk = jax.random.key(seed), trnd.key(seed)
    for i in range(8):
        want = int(jax.random.categorical(jax.random.fold_in(jk, i), jnp.asarray(logits)))
        got = int(trnd.categorical(trnd.fold_in(tk, i), torch.from_numpy(logits)))
        assert got == want
    g = np.asarray(jax.random.gumbel(jk, (50,)))
    np.testing.assert_allclose(trnd.gumbel(tk, (50,)).numpy(), g, rtol=4e-6, atol=4e-6)


def test_seed_outside_int64_raises_like_jax():
    for seed in (2**63, 2**64, -(2**63) - 1):
        with pytest.raises(OverflowError):
            jax.random.key(seed)
        with pytest.raises(OverflowError):
            trnd.key(seed)
    np.testing.assert_array_equal(trnd.key(-(2**63)).numpy(), _jkey_words(jax.random.key(-(2**63))))


def test_engine_seed_past_32_bits_inits_like_jax():
    """FLConfig(seed=2**32 + 7): both engines init from key(fl.seed)."""
    from repro.fl.task import MLPTask as JTask
    from repro_torch.fl.task import MLPTask

    seed = 2**32 + 7
    jp = JTask(dim=32, n_classes=10).init(jax.random.key(seed))
    tp = MLPTask(dim=32, n_classes=10).init(trnd.key(seed))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=4e-6, atol=4e-6)


def test_child_clusterer_keys_from_hash_seeds():
    """The coordinator seeds child clusterers with seed + hash(id) % 10_000
    (randomized per process, so computed here, inside the test)."""
    for child in ("0.0", "0.1", "0.1.0"):
        seed = 3 + hash(child) % 10_000
        jk, tk = jax.random.key(seed), trnd.key(seed)
        np.testing.assert_array_equal(trnd.split(tk).numpy(), _jkey_words(jax.random.split(jk)))


# ---------------------------------------------------------------------------
# Bounded draws: pieces of CHUNK values, card blocks, explicit counters
# ---------------------------------------------------------------------------
def _draws(tk, shape, **kw):
    """The four bounded draws of ``shape`` on ``tk`` (kw: shard)."""
    return {
        "bits": trnd.bits(tk, shape, **kw),
        "uniform": trnd.uniform(tk, shape, -0.5, 3.0, **kw),
        "normal": trnd.normal(tk, shape, scale=0.02, dtype=torch.bfloat16, **kw),
        "truncated_normal": trnd.truncated_normal(tk, -2.0, 2.0, shape, scale=0.125, **kw),
    }


def _bit_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.is_floating_point:  # the bit patterns
        iv = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(iv), b.view(iv)
    assert torch.equal(a, b)


def _count_pieces(monkeypatch) -> list:
    """The sizes of the pieces the draws make, from now on."""
    sizes, orig = [], trnd._pieces

    def counted(*a, **k):
        for piece in orig(*a, **k):
            sizes.append(piece[1] - piece[0])
            yield piece

    monkeypatch.setattr(trnd, "_pieces", counted)
    return sizes


def test_chunk_is_a_multiple_of_64():
    """Piece boundaries fall on multiples of 64 values, where the CPU's
    vectorised loops start: a piece never ends in another tail than the
    whole draw's (``erfinv`` runs scalar on the CPU; the tests below also
    cut at boundaries that are not multiples of the rows)."""
    assert trnd.CHUNK % 64 == 0 and trnd.CHUNK >= 1 << 16


@pytest.mark.parametrize("chunk", [64, 192, 4096])
@pytest.mark.parametrize("shape", [(37, 50), (3, 7, 61), (5000,)])
def test_chunked_draws_bit_equal_whole(monkeypatch, shape, chunk):
    """Drawn ``chunk`` values at a time (chunks that do not divide the leaf
    and end mid-row), each draw is bit-equal to the one-piece draw, and
    bits and [0, 1) uniforms to JAX's."""
    tk = trnd.key(42)
    whole = _draws(tk, shape)
    monkeypatch.setattr(trnd, "CHUNK", chunk)
    sizes = _count_pieces(monkeypatch)
    parts = _draws(tk, shape)
    n = int(np.prod(shape))
    assert len(sizes) == 4 * -(-n // chunk)
    assert all(m <= chunk for m in sizes)
    for name in whole:
        _bit_equal(parts[name], whole[name])
    jk = jax.random.key(42)
    np.testing.assert_array_equal(parts["bits"].numpy(),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(trnd.uniform(tk, shape).numpy(), np.asarray(jax.random.uniform(jk, shape)))


def test_chunked_batched_keys_bit_equal(monkeypatch):
    """A batch of keys (a musicgen head per codebook, DP noise per row)
    drawn in pieces equals its one-piece draw."""
    tks = trnd.split(trnd.key(3), 5)
    whole = _draws(tks, (9, 70))
    monkeypatch.setattr(trnd, "CHUNK", 640)  # 128 values a key a piece
    for name, a in _draws(tks, (9, 70)).items():
        _bit_equal(a, whole[name])


def _mesh_blocks(shape, mesh_shape):
    """Every card's block of a ``shape`` leaf split on dims 0 and 2 of a
    (data, model) mesh, on dim 1 over both, and on the last dim alone."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.utils.spmd import block

    layouts = ([Shard(0), Shard(2)], [Shard(1), Shard(1)], [Replicate(), Shard(len(shape) - 1)])
    for pl in layouts:
        for coords in np.ndindex(*mesh_shape):
            yield block(shape, pl, mesh_shape, coords)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (4, 4)])
def test_shard_draws_equal_whole_draw_elements(monkeypatch, mesh_shape):
    """Each card's block, drawn alone (whole rows a piece, and pieces of a
    row when a row is longer than a piece), equals that block of the whole
    draw, bit for bit."""
    shape = (8, 16, 32)
    tk = trnd.key(7)
    whole = _draws(tk, shape)
    for chunk in (trnd.CHUNK, 64, 192):
        monkeypatch.setattr(trnd, "CHUNK", chunk)
        for s in _mesh_blocks(shape, mesh_shape):
            for name, a in _draws(tk, shape, shard=s).items():
                _bit_equal(a, whole[name][s.slices()])


def test_counters_past_2_32_equal_jax_threefry():
    """A (128, 5120, 8192) expert leaf has 5.4G values: counters from 2**32
    on have the high word 1. Its elements 2**32 - 64 .. 2**32 + 63 (the end
    of one row, the start of the next) and the last 100 of expert 127,
    drawn as cards' blocks without the leaf, equal JAX's own
    ``threefry2x32_p`` on the same (hi, lo) words (partitionable threefry:
    bits = out1 ^ out2), and so do the uniforms."""
    from jax._src.prng import threefry2x32_p

    shape = (128, 5120, 8192)
    row = 2**32 // 8192  # the global row whose first counter is 2**32
    blocks = [trnd.Shard((1, 1, 64), (row // 5120, row % 5120 - 1, 8128)),
              trnd.Shard((1, 1, 64), (row // 5120, row % 5120, 0)),
              trnd.Shard((1, 1, 100), (127, 5119, 8092))]
    idx = np.concatenate([np.arange(2**32 - 64, 2**32 + 64), np.prod(shape) - 100 + np.arange(100)])
    hi, lo = (idx >> 32).astype(np.uint32), (idx & 0xFFFFFFFF).astype(np.uint32)
    assert hi[0] == 0 and hi[64] == 1
    for seed in (0, 1234 * 7919):
        words = _jkey_words(jax.random.key(seed)).astype(np.uint32)
        o1, o2 = threefry2x32_p.bind(jnp.uint32(words[0]), jnp.uint32(words[1]), jnp.asarray(hi), jnp.asarray(lo))
        want = (np.asarray(o1) ^ np.asarray(o2)).astype(np.int64)
        tk = trnd.key(seed)
        got = np.concatenate([trnd.bits(tk, shape, shard=s).reshape(-1).numpy() for s in blocks])
        np.testing.assert_array_equal(got, want)
        u = ((want >> 9) | 0x3F800000).astype(np.uint32).view(np.float32) - np.float32(1.0)
        got = np.concatenate([trnd.uniform(tk, shape, shard=s).reshape(-1).numpy() for s in blocks])
        np.testing.assert_array_equal(got, u)
