"""The port's kernel wrappers (repro_torch.kernels.ops) against the JAX
package's Pallas kernels (repro.kernels.ops, interpret mode on the CPU).

On the CPU the port's wrappers run their plain versions; the CUDA kernels
themselves are held against those plain versions on the card by the tests
marked ``cuda`` below (skipped without a card) and by ``chip_smoke.py``.
Tolerances are the JAX kernel tests' own: 2e-5 in f32, 2e-2 (cosine) and
5e-2 (segment) in bf16, where the inputs round to 8 mantissa bits.

JAX is imported inside the comparison tests only, so that the ``cuda``
tests also run on a card whose machine has no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

SHAPES = [(1, 128, 2), (7, 33, 3), (128, 512, 8), (200, 300, 5), (1024, 256, 16), (64, 64, 64)]
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def jax_ops():
    """(repro.kernels.ops, jax.numpy) of the JAX package."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    return jops, jnp


def _inputs(jnp, rng, shape, dname):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dname]
    jx = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
    # the same (rounded) values for both packages
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TORCH_DTYPES[dname])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_cosine_similarity_matches_jax(jax_ops, shape, dname):
    jops, jnp = jax_ops
    P, D, K = shape
    rng = np.random.default_rng(P * 1000 + D)
    jx, tx = _inputs(jnp, rng, (P, D), dname)
    jc, tc = _inputs(jnp, rng, (K, D), dname)
    want = np.asarray(jops.cosine_similarity(jx, jc))
    got = ops.cosine_similarity(tx, tc)
    assert got.dtype == torch.float32 and got.shape == (P, K)
    tol = 2e-5 if dname == "f32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_aggregate_matches_jax(jax_ops, shape, dname, weighted):
    jops, jnp = jax_ops
    P, D, K = shape
    rng = np.random.default_rng(P * 7 + D)
    jx, tx = _inputs(jnp, rng, (P, D), dname)
    ids = rng.integers(0, K, P).astype(np.int32)
    w = rng.random(P).astype(np.float32) if weighted else None
    want = np.asarray(
        jops.segment_aggregate(jx, jnp.asarray(ids), K, None if w is None else jnp.asarray(w))
    )
    got = ops.segment_aggregate(
        tx, torch.from_numpy(ids), K, None if w is None else torch.from_numpy(w)
    )
    assert got.dtype == torch.float32 and got.shape == (K, D)
    tol = 2e-5 if dname == "f32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("weighted", [False, True])
def test_cohort_axis_padding_ids_and_zero_rows(jax_ops, weighted):
    """Leading cohort axis, ids of -1 and >= K dropped, zero rows give 0,
    K = 1 and P = 0 -- the contract both packages' ops keep."""
    jops, jnp = jax_ops
    rng = np.random.default_rng(3)
    C, P, D, K = 3, 37, 70, 4
    x = rng.standard_normal((C, P, D)).astype(np.float32)
    x[:, 0] = 0.0
    c = rng.standard_normal((C, K, D)).astype(np.float32)
    ids = rng.integers(-1, K + 2, (C, P)).astype(np.int32)
    w = rng.random((C, P)).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    got = ops.cosine_similarity(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.cosine_similarity(jnp.asarray(x), jnp.asarray(c))),
        rtol=2e-5, atol=2e-5,
    )
    assert np.all(got[:, 0] == 0.0)
    want = np.asarray(jops.segment_aggregate(jnp.asarray(x), jnp.asarray(ids), K, jw))
    got = ops.segment_aggregate(torch.from_numpy(x), torch.from_numpy(ids), K, tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    one = ops.segment_aggregate(torch.from_numpy(x), torch.zeros(C, P, dtype=torch.int32), 1, tw)
    wsum = x * (1.0 if w is None else w[..., None])
    np.testing.assert_allclose(one.numpy()[:, 0], wsum.sum(1), rtol=1e-4, atol=1e-4)
    empty = ops.segment_aggregate(torch.zeros(0, D), torch.zeros(0, dtype=torch.int32), K)
    assert empty.shape == (K, D) and not empty.any()
    assert ops.cosine_similarity(torch.zeros(0, D), torch.ones(K, D)).shape == (0, K)


def test_unknown_device_raises():
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError):
        ops.cosine_similarity(x, x)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU run covers the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(512, 128, 4), (125, 6922, 7), (64, 128, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, shape, dtype):
    from repro_torch.kernels import cosine_sim, segment_aggregate

    P, D, K = shape
    g = torch.Generator(device=cuda).manual_seed(P + D)
    x = torch.randn(2, P, D, generator=g, device=cuda).to(dtype)
    c = torch.randn(2, K, D, generator=g, device=cuda).to(dtype)
    ids = torch.randint(-1, K + 1, (2, P), generator=g, device=cuda)
    w = torch.rand(2, P, generator=g, device=cuda)
    n_cos, n_seg = cosine_sim.launches, segment_aggregate.launches
    tc, ts = (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 5e-2)
    torch.testing.assert_close(ops.cosine_similarity(x, c), ref.cosine_similarity(x, c), rtol=tc, atol=tc)
    torch.testing.assert_close(
        ops.segment_aggregate(x, ids, K, w), ref.segment_aggregate(x, ids, K, w), rtol=ts, atol=ts
    )
    assert cosine_sim.launches == n_cos + 1 and segment_aggregate.launches == n_seg + 1
