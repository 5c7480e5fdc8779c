"""The port's SSM blocks (``repro_torch.models.ssm``: the chunked SSD scan,
Mamba-2, mLSTM and sLSTM) against ``repro.models.ssm``, in one process.

Inputs come from numpy seeds; JAX params go across with
``convert.params_from_numpy``. The blocks run at the reduced configs'
widths (zamba2-7b: d 256, 8 SSM heads of 64, state 16; xlstm-1.3b: d 256,
4 heads). Forward outputs and caches agree at tests/test_torch_lm_train.py's
2e-5, gradients (of a fixed random projection of the outputs) at rtol 1e-4
/ atol 1e-5 plus, where float32's own error is larger, twice the error
measured against a float64 run of the port (``GRAD_FLOOR``, a share of the
leaf's largest |g|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.models import ssm as jssm
from repro_torch import random as rnd
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as tssm
from repro_torch.utils.tree import leaves_with_path, tree_map

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
# float32's own error on the blocks' gradients (test_block_apply_and_grads),
# measured against a float64 run of the port on the same inputs: at most
# 8.9e-6 (mamba2), 3.1e-6 (mlstm) and 5.2e-6 (slstm) of a leaf's largest
# |g| for JAX, 1.27e-5 / 2.4e-6 / 4.7e-6 for the port; twice the larger is
# allowed, as a share of the leaf's scale, on top of GRAD's atol
GRAD_FLOOR = {"mamba2": 2.6e-5, "mlstm": 6.2e-6, "slstm": 1.1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return jreduce(jget(arch)).replace(**kw), treduce(tget(arch)).replace(**kw)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """A JAX tree (or one array) as the port's tensors."""
    if isinstance(tree, dict):
        return params_from_numpy(_np(tree), "cpu")
    return torch.from_numpy(np.array(tree))


def _flat(tree):
    """The tensors of a port tree (a tensor, a dict or a tuple of them) in
    JAX's leaf order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [v for _, v in leaves_with_path(tree)]
    return [l for t in tree for l in _flat(t)]


def _held(got, want, tol, what=""):
    """Every leaf of the port's tree (tensors) against the JAX tree."""
    want = dict(leaves_with_path(_np(want))) if isinstance(want, dict) else {"": np.asarray(want)}
    got = dict(leaves_with_path(got)) if isinstance(got, dict) else {"": got}
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], err_msg=f"{what} {k}", **tol)


def _grads_held(tg, jg, floor, what=""):
    want = dict(leaves_with_path(_np(jg)))
    got = dict(leaves_with_path(tg))
    assert got.keys() == want.keys()
    for k in want:
        s = float(np.abs(want[k]).max())
        assert s > 0, (what, k)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] + floor * s, err_msg=f"{what} {k}")


def _both_grads(jfn, tfn, jargs, seed):
    """Gradients of ``sum(w · out)`` for a fixed random w of each output
    leaf, over every argument (a dict of params and/or arrays), in both
    packages. Returns (JAX grads, port grads, JAX outputs, port outputs)."""
    jout = jfn(*jargs)
    flat = jax.tree.leaves(jout)
    ws = [_x(seed + i, np.shape(o)) for i, o in enumerate(flat)]

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(jfn(*a)), ws))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(len(jargs)))))(*jargs)
    targs = [tree_map(lambda t: t.requires_grad_(True), _t(a)) for a in jargs]
    tout = tfn(*targs)
    touts = _flat(tout)
    assert len(touts) == len(ws)
    loss = sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(touts, ws))
    grads = iter(torch.autograd.grad(loss, _flat(targs)))
    tg = [tree_map(lambda _: next(grads), a) for a in targs]
    return jg, tg, jout, tout


# ---------------------------------------------------------------------------
# the chunked SSD core
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, b=2, l=32, h=3, p=5, n=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    a = -rng.uniform(0.0, 0.5, (b, l, h)).astype(np.float32)
    B = rng.standard_normal((b, l, h, n)).astype(np.float32)
    C = rng.standard_normal((b, l, h, n)).astype(np.float32)
    return {"x": x, "a": a, "B": B, "C": C}


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_ssd_chunked_matches_jax(chunk):
    """Several chunks (8 -> 4 of them), one chunk, a chunk past the length
    (min(chunk, l)); outputs, final state and the gradients of all four
    inputs."""
    d = _ssd_inputs(0)
    jg, tg, (jy, jst), (ty, tst) = _both_grads(
        lambda d: jssm.ssd_chunked(d["x"], d["a"], d["B"], d["C"], chunk),
        lambda d: tssm.ssd_chunked(d["x"], d["a"], d["B"], d["C"], chunk),
        [{k: jnp.asarray(v) for k, v in d.items()}], 1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(tst.detach().numpy(), np.asarray(jst), **FWD)
    _grads_held(tg[0], jg[0], 0.0, f"chunk {chunk}")


def test_ssd_chunked_refuses_a_ragged_length():
    d = _ssd_inputs(1, l=20)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_chunked(*(torch.from_numpy(d[k]) for k in "xaBC"), 8)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*(jnp.asarray(d[k]) for k in "xaBC"), 8)


def test_ssd_step_chain_matches_the_chunked_scan():
    """The decode recurrence, token by token from a zero state, gives the
    chunked scan's outputs and final state; each step equals JAX's."""
    d = _ssd_inputs(2, l=16)
    y, final = tssm.ssd_chunked(*(torch.from_numpy(d[k]) for k in "xaBC"), 4)
    state = torch.zeros(final.shape)
    jstate = jnp.zeros(final.shape)
    for t in range(16):
        step = [d[k][:, t] for k in "xaBC"]
        yt, state = tssm.ssd_step(state, *(torch.from_numpy(s) for s in step))
        jyt, jstate = jssm.ssd_step(jstate, *(jnp.asarray(s) for s in step))
        np.testing.assert_allclose(yt.numpy(), np.asarray(jyt), **FWD)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **FWD)
        np.testing.assert_allclose(yt.numpy(), y[:, t].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), final.numpy(), rtol=1e-4, atol=1e-5)


def test_segsum_and_its_gradient_have_no_nan():
    """-inf above the diagonal; exp of it differentiates to zeros there."""
    a = torch.from_numpy(-np.abs(_x(3, (2, 6)))).requires_grad_(True)
    s = tssm._segsum(a)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(jssm._segsum(jnp.asarray(a.detach().numpy()))), **FWD)
    assert bool(torch.isneginf(s[:, 0, 1:]).all()) and not bool(torch.isinf(torch.tril(s[0])).any())
    (g,) = torch.autograd.grad(torch.exp(s).sum(), a)
    assert bool(torch.isfinite(g).all())
    jg = jax.grad(lambda a: jnp.exp(jssm._segsum(a)).sum())(jnp.asarray(a.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **FWD)


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv_matches_jax(with_carry):
    seq, w = _x(4, (2, 7, 12)), _x(5, (4, 12))
    carry = _x(6, (2, 3, 12)) if with_carry else None
    jo, jc = jssm._causal_conv(jnp.asarray(seq), jnp.asarray(w), None if carry is None else jnp.asarray(carry))
    to, tc = tssm._causal_conv(torch.from_numpy(seq), torch.from_numpy(w),
                               None if carry is None else torch.from_numpy(carry))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))  # the last kw - 1 inputs, copied


# ---------------------------------------------------------------------------
# inits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block,arch", [("mamba2", "zamba2_7b"), ("mlstm", "xlstm_1_3b"),
                                        ("slstm", "xlstm_1_3b")])
def test_block_inits_match_jax(block, arch):
    """The same key draws the same weights (1e-6, as the dense init is
    held: erfinv's last bits); the same tree, shapes and dtypes (the mLSTM
    gates float32)."""
    jcfg, tcfg = _cfgs(arch)
    want = dict(leaves_with_path(_np(getattr(jssm, f"{block}_init")(jax.random.key(7), jcfg))))
    got = dict(leaves_with_path(getattr(tssm, f"{block}_init")(rnd.key(7), tcfg)))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("H", [8, 112])
def test_mamba2_a_log_at_reduced_and_full_heads(H):
    """``A_log = log(linspace(1, 16, H))``: equal ramps at the reduced 8
    heads; at zamba2-7b's 112 the ramp and the log differ from XLA's by an
    ulp in places (2.4e-7 after the log), inside the inits' 1e-6."""
    jcfg, tcfg = _cfgs("zamba2_7b", ssm_heads=H)
    want = np.asarray(jssm.mamba2_init(jax.random.key(0), jcfg)["A_log"])
    got = tssm.mamba2_init(rnd.key(0), tcfg)["A_log"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if H == 8:
        np.testing.assert_array_equal(tssm._linspace(1.0, 16.0, H, "cpu").numpy(),
                                      np.asarray(jnp.linspace(1.0, 16.0, H).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Mamba-2, mLSTM, sLSTM: apply, decode, gradients
# ---------------------------------------------------------------------------
BLOCKS = {"mamba2": "zamba2_7b", "mlstm": "xlstm_1_3b", "slstm": "xlstm_1_3b"}


def _block(block, seed):
    jcfg, tcfg = _cfgs(BLOCKS[block])
    jp = getattr(jssm, f"{block}_init")(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_apply_and_grads_match_jax(block):
    """The training path on (2, 32, 256) inputs (2 SSD chunks of 16):
    outputs, and the gradients of every param leaf and of the input."""
    jcfg, tcfg, jp = _block(block, 11)
    x = _x(12, (2, 32, jcfg.d_model))
    japply, tapply = getattr(jssm, f"{block}_apply"), getattr(tssm, f"{block}_apply")
    jg, tg, jy, ty = _both_grads(lambda p, x: japply(p, jcfg, x), lambda p, x: tapply(p, tcfg, x),
                                 [jp, jnp.asarray(x)], 13)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    _grads_held(tg[0], jg[0], GRAD_FLOOR[block], f"{block} params")
    _grads_held({"x": tg[1]}, {"x": jg[1]}, GRAD_FLOOR[block], f"{block} input")


def _cache_init(block, jcfg, tcfg, b):
    if block == "slstm":
        return jssm.slstm_state_init(jcfg, b), tssm.slstm_state_init(tcfg, b)
    return getattr(jssm, f"{block}_cache_init")(jcfg, b), getattr(tssm, f"{block}_cache_init")(tcfg, b)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_decode_chain_matches_jax_and_the_training_path(block):
    """8 tokens decoded one at a time from the initial cache: each step's
    output and cache equal JAX's, and the outputs equal the training
    path's on the whole sequence (the recurrence and its chunked form)."""
    jcfg, tcfg, jp = _block(block, 21)
    tp = _t(jp)
    x = _x(22, (2, 8, jcfg.d_model))
    jc, tc = _cache_init(block, jcfg, tcfg, 2)
    _held(tc, jc, dict(rtol=0, atol=0), "initial cache")
    jdec, tdec = getattr(jssm, f"{block}_decode"), getattr(tssm, f"{block}_decode")
    outs = []
    for t in range(8):
        jy, jc = jdec(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tdec(tp, tcfg, torch.from_numpy(x[:, t:t + 1]), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), err_msg=f"step {t}", **FWD)
        _held(tc, jc, FWD, f"{block} cache step {t}")
        outs.append(ty)
    full = getattr(tssm, f"{block}_apply")(tp, tcfg.replace(ssm_chunk=4), torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), rtol=1e-4, atol=1e-5)


def test_slstm_cell_gradient_at_the_first_step_tie_matches_jax():
    """From the initial state (m = -30) the stabilizer makes m_new = i_pre,
    so n_new = exp(0) = 1 exactly and max(|n|, 1) ties in every element:
    jnp.maximum and torch.maximum both split that gradient in halves (held
    directly below). The split reaches no gradient at float32's
    resolution: i = exp(i_pre - m_new) has a zero derivative there, and
    n_new = f·n + i passes it to the incoming n with f ≈ exp(-30) (a
    clamp in its place passes this test too). The cell's outputs and
    gradients (r, wx and the whole incoming state) are held; a second step
    from the first's state is held too."""
    jcfg, tcfg, jp = _block("slstm", 31)
    b, nh, hd = 2, tcfg.n_heads, tcfg.d_model // tcfg.n_heads
    wx = _x(32, (b, nh, 4, hd))
    state0 = tssm.slstm_state_init(tcfg, b)
    first = tssm.slstm_cell(_t(jp)["r"], torch.from_numpy(wx), state0)
    assert bool((first["n"] == 1.0).all())  # the tie, in every element
    jstate0 = jssm.slstm_state_init(jcfg, b)
    jg, tg, jout, tout = _both_grads(
        lambda r, wx, h, c, n: jssm.slstm_cell(r, wx, dict(jstate0, h=h, c=c, n=n)),
        lambda r, wx, h, c, n: tssm.slstm_cell(r, wx, dict(state0, h=h, c=c, n=n)),
        [jp["r"], jnp.asarray(wx), jnp.asarray(_x(33, (b, nh, hd))), jstate0["c"], jstate0["n"]], 34)
    _held(tout, jout, FWD, "first step")
    for j, t, name in zip(jg, tg, ("r", "wx", "h", "c", "n")):
        _grads_held({name: t}, {name: j}, GRAD_FLOOR["slstm"], "first step")
    # at the tie each side of max(|n|, 1) takes half the gradient, in both
    n = torch.ones(3, requires_grad=True)
    (gn,) = torch.autograd.grad(torch.maximum(torch.abs(n), tssm._one(n)).sum(), n)
    jgn = jax.grad(lambda n: jnp.maximum(jnp.abs(n), 1.0).sum())(jnp.ones(3))
    assert gn.tolist() == np.asarray(jgn).tolist() == [0.5] * 3
    # a second step, from the first step's state (no tie there)
    jsec = jssm.slstm_cell(jp["r"], jnp.asarray(_x(35, wx.shape)),
                           jssm.slstm_cell(jp["r"], jnp.asarray(wx), jstate0))
    tsec = tssm.slstm_cell(_t(jp)["r"], torch.from_numpy(_x(35, wx.shape)), first)
    _held(tsec, jsec, FWD, "second step")
