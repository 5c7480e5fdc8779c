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
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
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


# ------------------------------------------- the kernel's split and merge plan
H100_SMS = 132


@pytest.mark.parametrize("per_sm", [1, 2, 4])
@pytest.mark.parametrize("B,Hkv,S", [(8, 8, 128), (128, 8, 32768), (8, 8, 32768), (1, 8, 32768),
                                     (2, 8, 512), (2, 8, 520), (2, 4, 4096), (4, 8, 16384),
                                     (3, 2, 300), (1, 1, 100000)])
def test_plan_splits_covers_every_valid_token_once(B, Hkv, S, per_sm):
    n, chunk = da.plan_splits(B, Hkv, S, H100_SMS, per_sm)
    assert 1 <= n <= 65535 and n * chunk >= S and (n - 1) * chunk < S
    if n > 1:  # one wave of blocks, chunks of whole block steps
        assert chunk % da.TILE == 0 and chunk >= da.MIN_CHUNK
        assert B * Hkv * n <= H100_SMS * per_sm
    for length in (0, 1, S // 3, S - 1, S):
        n_eff = S if length <= 0 else length
        if n_eff == 0:
            continue
        owner = np.arange(n_eff) // chunk  # the one split whose [start, end) holds each token
        assert owner.max() < n
        active = np.arange(n) * chunk < n_eff  # blocks that do not exit at once
        assert active[0]  # split 0 is never empty
        assert np.array_equal(np.bincount(owner, minlength=n) > 0, active)


def test_plan_splits_at_the_timed_shapes():
    # the main path's page and the decode_32k batch: one split, one launch
    assert da.plan_splits(8, 8, 128, H100_SMS, 2) == (1, 128)
    assert da.plan_splits(128, 8, 32768, H100_SMS, 1) == (1, 32768)
    # 8 sequences of 32k fill one wave: 2 splits of 16k at one bf16 block
    # per SM (128 of 132 SMs), 4 of 8k at two f32 blocks per SM
    assert da.plan_splits(8, 8, 32768, H100_SMS, 1) == (2, 16384)
    assert da.plan_splits(8, 8, 32768, H100_SMS, 2) == (4, 8192)
    for per_sm in (1, 2):
        n, _ = da.plan_splits(8, 8, 32768, H100_SMS, per_sm)
        assert 0.95 * H100_SMS * per_sm <= 8 * 8 * n <= H100_SMS * per_sm


def emulate(q, k, v, length, n_split, chunk, bf16):
    """The kernel's order of work in plain PyTorch (float32). Split s
    takes tokens [s chunk, (s + 1) chunk) of the valid prefix; in it, warp
    w takes tokens [16 w, 16 w + 16) of every 64-token step and keeps its
    own online softmax (running max m, normaliser l, accumulator), with
    P rounded to bf16 before P · V in the bf16 path; the warps' states
    merge in warp order, then the splits' in split order."""
    W, R = 4, 16
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    steps = math.ceil(chunk / (W * R))
    n = torch.as_tensor(length).broadcast_to((B,))
    n_eff = torch.where(n <= 0, torch.full_like(n, S), n.clamp(max=S))
    tok = (torch.arange(n_split)[:, None, None, None] * chunk
           + torch.arange(steps)[None, :, None, None] * W * R
           + torch.arange(W)[None, None, :, None] * R + torch.arange(R))  # (ns, steps, W, R)
    end = torch.minimum((torch.arange(n_split)[None, :] + 1) * chunk, n_eff[:, None])  # (B, ns)
    valid = tok[None] < end[:, :, None, None, None]  # (B, ns, steps, W, R)
    tc = tok.clamp(max=S - 1).reshape(-1)
    kg = k.float()[:, tc].reshape(B, *tok.shape, Hkv, hd)
    vg = v.float()[:, tc].reshape(B, *tok.shape, Hkv, hd)
    qg = q.float().reshape(B, Hkv, g, hd)
    s = torch.einsum("bngd,bxiwrnd->bngxiwr", qg, kg) / math.sqrt(hd)
    s = torch.where((n <= 0)[:, None, None, None, None, None, None], torch.tensor(-1e30), s)
    s = s.masked_fill(~valid[:, None, None], -math.inf)
    m = torch.cummax(s.amax(-1), dim=-2).values  # (B, Hkv, g, ns, steps, W): running max
    m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # steps a warp never takes
    p = torch.exp(s - m_fin[..., None])
    pq = p.bfloat16().float() if bf16 else p
    last = m[..., -1:, :]  # each warp's final max
    last_fin = torch.where(torch.isfinite(last), last, torch.zeros_like(last))
    scale = torch.where(torch.isfinite(m), torch.exp(m - last_fin), torch.zeros_like(m))
    l_w = (p.sum(-1) * scale).sum(-2)  # (B, Hkv, g, ns, W)
    acc_w = torch.einsum("bngxiwr,bxiwrnd->bngxiwd", pq, vg)
    acc_w = (acc_w * scale[..., None]).sum(-3)  # (B, Hkv, g, ns, W, hd)
    m_w = last[..., 0, :]  # (B, Hkv, g, ns, W)

    def merge(m_, l_, a_):  # over the last axis of m_ and l_ (a_: one before hd)
        top = m_.amax(-1, keepdim=True)
        top_fin = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
        w = torch.where(torch.isfinite(m_), torch.exp(m_ - top_fin), torch.zeros_like(m_))
        return top.squeeze(-1), (l_ * w).sum(-1), (a_ * w[..., None]).sum(-2)

    m_s, l_s, a_s = merge(m_w, l_w, acc_w)  # warps -> (B, Hkv, g, ns)
    _, l_o, a_o = merge(m_s, l_s, a_s)  # splits -> (B, Hkv, g)
    return (a_o / l_o.clamp(min=1e-30)[..., None]).reshape(B, H, hd)


# (B, H, Hkv, hd, S, lengths, chunk): None = plan_splits' chunk on an H100
# (one bf16 block per SM, two f32 blocks)
EMULATED = [(2, 8, 2, 16, 64, 40, None), (1, 4, 4, 32, 128, 128, None),
            (3, 16, 2, 64, 300, 200, None), (2, 8, 8, 128, 1024, 1, None),
            (4, 8, 4, 32, 256, [1, 64, 200, 256], 64), (3, 8, 2, 16, 64, [0, 5, 0], None),
            (2, 40, 8, 128, 520, [520, 263], None), (2, 64, 4, 128, 4096, [4096, 2051], None),
            (4, 32, 8, 64, 4096, [0, 1, 3000, 4096], 512),
            (1, 32, 8, 64, 32768, 32768, None)]


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: f"B{c[0]}-H{c[1]}-Hkv{c[2]}-hd{c[3]}-S{c[4]}")
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_kernel_order_matches_jax_reference(jax_kernels, case, dname):
    """The kernel's split / step / warp / merge order, with P rounded to
    bf16 in the bf16 path, within the JAX tests' tolerance of the JAX
    package's reference; the 32k case shows that the rounding of P fits
    3e-2 at the long cache."""
    _, jref, jnp = jax_kernels
    B, H, Hkv, hd, S, L, chunk = case
    rng = np.random.default_rng(B * 1000 + S)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(jnp, rng, B, H, Hkv, hd, S, dname)
    n_split, chunk_ = da.plan_splits(B, Hkv, S, H100_SMS, 1 if dname == "bf16" else 2)
    if chunk is not None:
        n_split, chunk_ = math.ceil(S / chunk), chunk
    got = emulate(tq, tk, tv, torch.tensor(L), n_split, chunk_, dname == "bf16")
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(L)).astype(jnp.float32)
    _close(got, want, TOL[dname])


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 8, 128), (2, 48, 4, 128), (2, 64, 4, 128)],
                         ids=["g5", "g12", "g16"])
@pytest.mark.parametrize("S", [512, 520, 4096])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_cuda_kernel_groups_of_the_configs(cuda, shape, S, dname):
    """g = 5 (llama4-maverick), 12 (starcoder2), 16 (qwen3-moe), with one
    split (S 512), two (520) and eight (4096)."""
    B, H, Hkv, hd = shape
    g = torch.Generator(device=cuda).manual_seed(H * 10 + S)
    dt = TORCH_DTYPES[dname]
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dt)
    n = torch.tensor([S, S // 2 + 3], device=cuda)
    got, again = ops.decode_attention(q, k, v, n), ops.decode_attention(q, k, v, n)
    want = ref.decode_attention(q, k, v, n)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dname], atol=TOL[dname])


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_cuda_kernel_ragged_long_cache(cuda, dname):
    """Lengths 0 (the mean of V over all S), 1, and ragged, over 8192."""
    B, H, Hkv, hd, S = 4, 32, 8, 64, 8192
    g = torch.Generator(device=cuda).manual_seed(11)
    dt = TORCH_DTYPES[dname]
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dt)
    n = torch.tensor([0, 1, 5000, 8192], device=cuda)
    before = da.launches
    got, again = ops.decode_attention(q, k, v, n), ops.decode_attention(q, k, v, n)
    want = ref.decode_attention(q, k, v, n)
    assert da.launches == before + 2 and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dname], atol=TOL[dname])
