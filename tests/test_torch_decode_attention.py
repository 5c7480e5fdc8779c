"""The port's decode attention (``repro_torch.kernels.ops.decode_attention``)
against the JAX package's Pallas kernel (interpret mode on the CPU, as the
JAX kernel tests run it) and its plain oracle.

On the CPU the port's wrapper runs its plain version; the CUDA kernel
itself is held against that plain version on the card by the tests marked
``cuda`` below (skipped without a card) and by ``chip_smoke.py``.
Tolerances are the JAX kernel tests' own: 2e-5 in f32 and 3e-2 in bf16,
where the inputs and the output round to 8 mantissa bits.

JAX is imported inside the comparison tests only, so that the ``cuda``
tests also run on a card whose machine has no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attention.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

# tests/test_decode_attention_kernel.py: (B, H, Hkv, hd, S, length)
SHAPES = [(2, 8, 2, 16, 64, 40), (1, 4, 4, 32, 128, 128), (3, 16, 2, 64, 300, 200),
          (2, 8, 8, 128, 1024, 1)]
TOL = {"f32": 2e-5, "bf16": 3e-2}
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_kernels():
    """(repro.kernels.ops, repro.kernels.ref, jax.numpy) of the JAX package."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jops, jref, jnp


def _inputs(jnp, rng, shape, dname):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dname]
    jx = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
    # the same (rounded) values for both packages
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TORCH_DTYPES[dname])


def _qkv(jnp, rng, B, H, Hkv, hd, S, dname):
    return [_inputs(jnp, rng, s, dname) for s in ((B, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_decode_attention_matches_jax(jax_kernels, shape, dname):
    jops, jref, jnp = jax_kernels
    B, H, Hkv, hd, S, L = shape
    rng = np.random.default_rng(B * 100 + S)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(jnp, rng, B, H, Hkv, hd, S, dname)
    got = ops.decode_attention(tq, tk, tv, L)
    assert got.dtype == tq.dtype and got.shape == (B, H, hd)
    tol = TOL[dname]
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(L), block_s=128).astype(jnp.float32), tol)
    _close(got, jref.decode_attention(jq, jk, jv, jnp.asarray(L)).astype(jnp.float32), tol)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_per_sequence_lengths_match_jax(jax_kernels, dname):
    jops, jref, jnp = jax_kernels
    B, H, Hkv, hd, S = 4, 8, 4, 32, 256
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(jnp, rng, B, H, Hkv, hd, S, dname)
    lens = [1, 64, 200, 256]
    got = ops.decode_attention(tq, tk, tv, torch.tensor(lens))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=128)
    _close(got, want.astype(jnp.float32), TOL[dname])
    for b in range(B):  # each sequence alone, with a scalar length
        one = ops.decode_attention(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1], lens[b])
        torch.testing.assert_close(one, got[b:b + 1], rtol=0, atol=0)


def test_length_zero_is_the_mean_of_v(jax_kernels):
    """length 0 masks every position to -1e30: the softmax is uniform over
    all S, as in the JAX oracle."""
    jops, jref, jnp = jax_kernels
    B, H, Hkv, hd, S = 3, 8, 2, 16, 64
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(jnp, rng, B, H, Hkv, hd, S, "f32")
    lens = [0, 5, 0]
    got = ops.decode_attention(tq, tk, tv, torch.tensor(lens))
    _close(got, jref.decode_attention(jq, jk, jv, jnp.asarray(lens)), 2e-5)
    mean_v = tv.mean(dim=1).repeat_interleave(H // Hkv, dim=1)  # (B, H, hd)
    torch.testing.assert_close(got[0], mean_v[0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[2], mean_v[2], rtol=2e-5, atol=2e-5)


def test_strided_cache_slice_reads_like_a_copy():
    """A layer slice of a (rows, lanes, L, S, Hkv, hd) cache, flattened to
    (rows·lanes, S, Hkv, hd), gives what a dense copy of it gives."""
    g = torch.Generator().manual_seed(3)
    cache = torch.randn(2, 4, 3, 64, 2, 16, generator=g)
    kl = cache[:, :, 1].reshape(8, 64, 2, 16)
    assert not kl.is_contiguous()
    q = torch.randn(8, 4, 16, generator=g)
    lens = torch.randint(0, 65, (8,), generator=g)
    got = ops.decode_attention(q, kl, kl, lens)
    want = ref.decode_attention(q, kl.contiguous(), kl.contiguous(), lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel runs only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_cuda_kernel_matches_plain(cuda, shape, dname):
    from repro_torch.kernels import decode_attention as da

    B, H, Hkv, hd, S, L = shape
    g = torch.Generator(device=cuda).manual_seed(B * 100 + S)
    dt = TORCH_DTYPES[dname]
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dt)
    for n in (L, torch.randint(0, S + 1, (B,), generator=g, device=cuda)):
        before = da.launches
        got = ops.decode_attention(q, k, v, n)
        again = ops.decode_attention(q, k, v, n)
        want = ref.decode_attention(q, k, v, n)
        torch.cuda.synchronize()
        assert da.launches == before + 2  # a CUDA tensor always takes the kernel
        assert torch.equal(got, again)  # bit-identical from run to run
        tol = TOL[dname]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_reads_a_strided_cache_slice(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    cache = torch.randn(2, 4, 3, 256, 8, 64, generator=g, device=cuda)
    kl = cache[:, :, 2].reshape(8, 256, 8, 64)
    q = torch.randn(8, 32, 64, generator=g, device=cuda)
    lens = torch.randint(1, 257, (8,), generator=g, device=cuda)
    got = ops.decode_attention(q, kl, kl, lens)
    want = ref.decode_attention(q, kl, kl, lens)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
