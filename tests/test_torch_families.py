"""The port's other attention families against the JAX package, in one
process: the MoE, VLM and audio inits and parameter counts, Qwen2-VL's
M-RoPE and early fusion, musicgen's codebook embeddings, heads and CE, the
last-block sketch and ``TransformerTask`` over MoE trees.

Inputs come from numpy seeds; JAX params go across with
``convert.params_from_numpy``. Counts and discrete outputs are equal;
floats agree at rtol 1e-4 / atol 1e-5 (forward logits at
tests/test_torch_lm_train.py's 2e-5), the gradients with that file's
allowance for XLA's float32 error (3e-4 of each leaf's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.core.sketch import GradientSketcher as JSketcher
from repro.fl.task import TransformerTask as JTask
from repro.launch import steps as js
from repro.models import build_model as jbuild
from repro.models import common as jc
from repro_torch import random as rnd
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.core.sketch import GradientSketcher as TSketcher
from repro_torch.fl.task import TransformerTask as TTask
from repro_torch.launch import steps as ts
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tc
from repro_torch.utils.tree import leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=2e-5, atol=2e-5)
FAMILIES = ["qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b", "qwen2_vl_2b", "musicgen_large"]
# The reduced configs' attention is nearly one-hot (the reference's fan-in
# of (D, H, hd) projections is H, so q and k come out ~10x unit scale), and
# a near tie between two keys magnifies float32's rounding: the logits'
# own error against a float64 run of the port is up to 5.2e-5 (JAX) /
# 1.15e-4 (the port) for qwen2-vl and 1.50e-4 / 1.88e-4 for musicgen, at a
# few positions. Twice the larger is allowed on top of FWD's atol. The
# gradients' own error there reaches 2.7e-4 / 9.1e-4 (qwen2-vl) and
# 1.56e-3 / 1.99e-3 (musicgen) of a leaf's largest |g| (at wq): twice the
# larger, as a share of the leaf's scale, in place of the 3e-4 below.
LOGIT_FLOOR = {"qwen2_vl_2b": 2.5e-4, "musicgen_large": 4e-4}
GRAD_FLOOR = {"qwen2_vl_2b": 2e-3, "musicgen_large": 4e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, **kw):
    jm = jbuild(jreduce(jget(arch)).replace(**kw))
    tm = tbuild(treduce(tget(arch)).replace(**kw))
    return jm, tm


def _carried(arch, seed, **kw):
    jm, tm = _models(arch, **kw)
    jp = jax.jit(jm.init)(jax.random.key(seed))
    return jm, tm, jp, params_from_numpy(_np(jp), "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_init_matches_jax(arch):
    """Same keys, same threefry draws: every leaf equal up to the last bits
    of erfinv (1e-6, as the dense init is held), the same tree and shapes;
    a bank slot is init(fold_in(key, i))."""
    jm, tm = _models(arch)
    want = dict(leaves_with_path(_np(jax.jit(jm.init)(jax.random.key(11)))))
    got = dict(leaves_with_path(tm.init(rnd.key(11), device="cpu")))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
    bank = dict(leaves_with_path(tm.init_bank(rnd.key(11), 2, device="cpu")))
    slot1 = dict(leaves_with_path(tm.init(rnd.fold_in(rnd.key(11), 1), device="cpu")))
    assert all(torch.equal(bank[k][1], slot1[k]) for k in slot1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_counts_match_jax(arch):
    """The full configs' counts on the meta device (no storage)."""
    jm, tm = jbuild(jget(arch)), tbuild(tget(arch))
    assert tm.param_count() == jm.param_count()
    assert tm.active_param_count() == jm.active_param_count()
    if arch.startswith("qwen3"):
        assert tm.param_count() == 231_742_373_632
        assert tbuild(tget(arch).replace(n_layers=1)).param_count() == 3_696_767_104


def test_apply_mrope_matches_jax():
    """Three different position streams, qwen2-vl's sections (16, 24, 24)
    over hd 128; sections that miss hd/2 are refused (the JAX package
    asserts)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 3, 7)).astype(np.int32)
    want = jc.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (16, 24, 24))
    got = tc.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (16, 24, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # one stream throughout equals the plain RoPE
    same = np.broadcast_to(pos[:, :1], pos.shape).copy()
    np.testing.assert_allclose(tc.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6, (16, 24, 24)),
                               tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:, 0]), 1e6),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="hd/2"):
        tc.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (16, 24, 16))
    with pytest.raises(AssertionError):
        jc.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (16, 24, 16))


def test_default_positions_mrope_match_jax():
    jm, tm = _models("qwen2_vl_2b")
    np.testing.assert_array_equal(tc.default_positions(tm.cfg, 2, 5).numpy(),
                                  np.asarray(jc.default_positions(jm.cfg, 2, 5)))
    off = np.array([[3], [9]], np.int32)
    got = tc.default_positions(tm.cfg, 2, 1, offset=torch.from_numpy(off))
    assert tuple(got.shape) == (2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.default_positions(jm.cfg, 2, 1, jnp.asarray(off))))


def _grads_held(tg, jg, arch):
    """XLA's float32 CPU gradients sit up to ~2e-4 of each leaf's scale
    from float64 (tests/test_torch_lm_train.py): rtol 1e-4 plus 3e-4 of it,
    or the family's measured ``GRAD_FLOOR``."""
    want = dict(leaves_with_path(_np(jg)))
    assert [k for k, _ in leaves_with_path(tg)] == sorted(want)
    for k, g in leaves_with_path(tg):
        s = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=max(3e-4, GRAD_FLOOR[arch]) * s,
                                   err_msg=k)


def _logit_tol(arch):
    return dict(rtol=FWD["rtol"], atol=FWD["atol"] + LOGIT_FLOOR[arch])


def _decode_chain(jm, tm, jp, tp, tok_at, tol, n=6):
    jcache, tcache = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    jstep = jax.jit(jm.decode_step)
    for i in range(n):
        t = tok_at(i)
        jl, jcache = jstep(jp, jnp.asarray(t), jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(t), tcache)
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **tol)
    np.testing.assert_array_equal(tcache["blocks"]["index"].numpy(), np.asarray(jcache["blocks"]["index"]))


def test_vlm_forward_loss_and_decode_match_jax():
    """Reduced qwen2-vl (M-RoPE sections (16, 8, 8)): 8 image patches
    projected and prepended to 8 text tokens; logits over the text positions
    only; loss and per-leaf gradients (vis_proj's included); prefill; then
    6 text tokens decoded against the cache."""
    jm, tm, jp, tp = _carried("qwen2_vl_2b", 3, attn_qchunk=8, ce_chunk=8)
    P = tm.cfg.vision_patches
    tok = _tokens(3, (2, 16 - P), tm.cfg.vocab)
    img = np.random.default_rng(3).standard_normal((2, P, tm.cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok), "image_embeds": jnp.asarray(img)}
    tb = {"tokens": torch.from_numpy(tok), "image_embeds": torch.from_numpy(img)}
    jl, _ = jm.forward(jp, jb)
    tl, _ = tm.forward(tp, tb)
    assert tuple(tl.shape) == (2, 16 - P, tm.cfg.vocab)
    tol = _logit_tol("qwen2_vl_2b")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    # the image changes the text logits (fusion reached the text positions)
    assert float((tm.forward(tp, {"tokens": tb["tokens"]})[0] - tl).abs().max()) > 1e-3
    (jloss, _), jg = jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True)(jp)
    (tloss, _), tg = ts.loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    _grads_held(tg, jg, "qwen2_vl_2b")
    assert float(tg["vis_proj"].abs().max()) > 0
    jpre = js.make_prefill_step(jm, js.StepConfig())(jp, jb)
    tpre = ts.make_prefill_step(tm, ts.StepConfig())(tp, tb)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **tol)
    _decode_chain(jm, tm, jp, tp, lambda i: tok[:, i:i + 1], tol)


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_audio_forward_ce_and_decode_match_jax(ce_chunk):
    """Reduced musicgen (4 codebooks, vocab 64): tokens (B, nc, S), logits
    (B, S, nc, V); the CE averaged over codebooks, chunked or not; per-leaf
    gradients; then 6 steps of (B, nc, 1) tokens against the cache."""
    jm, tm, jp, tp = _carried("musicgen_large", 4, attn_qchunk=8, ce_chunk=ce_chunk)
    nc = tm.cfg.n_codebooks
    tok = _tokens(4, (2, nc, 16), tm.cfg.vocab)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    jl, _ = jm.forward(jp, jb)
    tl, _ = tm.forward(tp, tb)
    assert tuple(tl.shape) == (2, 16, nc, tm.cfg.vocab)
    tol = _logit_tol("musicgen_large")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    if ce_chunk:  # gradients and decode once, on the chunked head
        (jloss, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True)(jp)
        (tloss, tmet), tg = ts.loss_and_grads(tm, tp, tb)
    else:
        (jloss, jmet), (tloss, tmet) = jm.loss(jp, jb), tm.loss(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), **FWD)
    # the mean over codebooks of each codebook's own next-token CE
    lg = tl[:, :-1].double()
    want = (torch.logsumexp(lg, -1) - torch.gather(lg, -1, tb["tokens"][:, :, 1:].transpose(1, 2)
                                                   .long()[..., None])[..., 0]).mean()
    np.testing.assert_allclose(float(tloss), float(want), rtol=1e-5)
    if ce_chunk:
        _grads_held(tg, jg, "musicgen_large")
        _decode_chain(jm, tm, jp, tp, lambda i: tok[:, :, i:i + 1], tol)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b"])
def test_last_block_sketch_over_moe_trees_matches_jax(arch):
    """Per-client deltas of an MoE tree: the selection is the final norm,
    the head and l[-1] of every backbone leaf with >= 2 dims (llama4: of
    both stacks), in JAX's sorted leaf order; the sketches equal JAX's."""
    jm, tm = _models(arch, d_model=64, vocab=128)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    rng = np.random.default_rng(5)
    deltas = jax.tree.map(lambda a: (0.01 * rng.standard_normal((2,) + a.shape)).astype(np.float32), shapes)
    want = np.asarray(jax.vmap(JSketcher(d_sketch=16, strategy="last_block_proj"))(
        jax.tree.map(jnp.asarray, deltas)))
    sk = TSketcher(d_sketch=16, strategy="last_block_proj")
    tdeltas = params_from_numpy(deltas, "cpu")
    np.testing.assert_allclose(sk.batch(tdeltas).numpy(), want, rtol=1e-5, atol=1e-5)
    picked = [k for k, _ in sk._selected(tdeltas)]
    assert picked == [k for k, _ in leaves_with_path(tdeltas)
                      if "backbone" in k or "final_norm" in k or "head" in k]
    stacks = sorted(tdeltas["backbone"])
    assert stacks == (["blocks"] if arch.startswith("qwen3") else ["dense_blocks", "moe_blocks"])
    assert any("['moe']['wg']" in k for k in picked)


def test_transformer_task_over_moe_matches_jax():
    """TransformerTask's loss and next-token accuracy over a reduced
    qwen3-moe tree, and the per-row accuracy of stacked params (R = 2)
    against the JAX package's vmap."""
    jm, tm, jp, tp = _carried("qwen3_moe_235b_a22b", 6)
    tok = _tokens(7, (3, 16), jm.cfg.vocab)
    tok[:, 8:] = tok[:, :8]
    jtask, ttask = JTask(jm), TTask(tm)
    np.testing.assert_allclose(float(ttask.loss(tp, (torch.from_numpy(tok), None))),
                               float(jtask.loss(jp, (jnp.asarray(tok), None))), **FWD)
    assert ttask.accuracy(tp, torch.from_numpy(tok)) == pytest.approx(
        jtask.accuracy(jp, jnp.asarray(tok)), abs=1e-6)
    jp2 = jax.jit(jm.init)(jax.random.key(7))
    jstack = jax.tree.map(lambda a, b: jnp.stack([a, b]), jp, jp2)
    toks = np.stack([tok, _tokens(8, (3, 16), jm.cfg.vocab)])
    want = jax.vmap(jtask.correct_fraction)(jstack, jnp.asarray(toks))
    got = ttask.correct_fraction(params_from_numpy(_np(jstack), "cpu"), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
