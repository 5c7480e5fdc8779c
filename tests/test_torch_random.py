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
