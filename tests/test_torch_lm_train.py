"""The port's LM training slice (``repro_torch.launch.steps``, the training
attention, the chunked CE head, ``TransformerTask``, ``checkpoint.npz``,
``launch.train``) against the JAX package, in one process.

Inputs come from numpy seeds; JAX params go across with
``convert.params_from_numpy``. Forward and loss agree within 2e-5, the
gradients and whole train steps within rtol 1e-4 / atol 1e-5 (XLA and torch
sum matrix products in different orders; the train steps with a fixed
allowance for float32's own error, ``F32_FLOOR``), and cluster assignments
exactly.
The segment kernel at the LM path's shapes is held against its plain
version on a card in ``tests/test_torch_lm_segment.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.core.sketch import GradientSketcher as JSketcher
from repro.fl.task import TransformerTask as JTask
from repro.launch import steps as js
from repro.models import build_model as jbuild
from repro.models import transformer as jt
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.core import sketch as tsketch
from repro_torch.fl.task import TransformerTask as TTask
from repro_torch.launch import steps as ts
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as tt
from repro_torch.utils.tree import leaves_with_path, tree_map

FWD = dict(rtol=2e-5, atol=2e-5)
STEP = dict(rtol=1e-4, atol=1e-5)
# Three rounds of make_train_step hold at STEP plus a fixed allowance per
# tree: twice float32's own error there, measured on these inputs against
# the same rounds in float64 (the JAX package's and the port's alike). It is
# large at places: a client's delta is the difference of float32 params one
# local run apart (their rounding is ~1e-4 of it), and centering the
# clients' similar sketches magnifies it. Measured: embedding params 5e-5,
# centroids 9.1e-4, dispersion and reward_mean up to 7.7e-4, opt state
# within STEP's atol.
F32_FLOOR = {"params": 1e-4, "opt": 0.0, "clust": 2e-3, "metrics": 1.5e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch="granite_3_2b", **kw):
    jm = jbuild(jreduce(jget(arch)).replace(**kw))
    tm = tbuild(treduce(tget(arch)).replace(**kw))
    return jm, tm


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(jp):
    return params_from_numpy(_np(jp), "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _assert_trees(got, want, tol, what=""):
    got, want = dict(leaves_with_path(got)), dict(leaves_with_path(_np(want)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], err_msg=what + k, **tol)


@pytest.fixture(scope="module")
def granite():
    """A reduced granite-3-2b (2 layers, d 256, tied head) with chunked
    attention and CE, its JAX params and their port copy."""
    jm, tm = _models(attn_qchunk=8, ce_chunk=8)
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, _carry(jp)


@pytest.mark.parametrize("qchunk,cechunk", [(0, 0), (8, 8), (0, 8), (8, 0)])
def test_forward_and_loss_match_jax(qchunk, cechunk):
    jm, tm = _models(attn_qchunk=qchunk, ce_chunk=cechunk)
    jp = jm.init(jax.random.key(1))
    tp = _carry(jp)
    tok = _tokens(1, (2, 16), jm.cfg.vocab)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    assert float(aux["lb_loss"]) == 0.0
    (jloss, jmet) = jm.loss(jp, {"tokens": jnp.asarray(tok)})
    (tloss, tmet) = tm.loss(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), **FWD)


def test_gradients_match_jax(granite):
    jm, tm, jp, tp = granite
    tok = _tokens(2, (2, 16), jm.cfg.vocab)
    jg = jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(tok)})[0])(jp)
    (loss, _), tg = ts.loss_and_grads(tm, tp, {"tokens": torch.from_numpy(tok)})
    assert [k for k, _ in leaves_with_path(tg)] == [k for k, _ in leaves_with_path(tp)]
    # XLA's float32 gradients on the CPU sit 0.6-2.1e-4 of each leaf's
    # largest |g| from a float64 evaluation (the port's: 0.4-3e-5), so the
    # comparison with JAX takes rtol 1e-4 plus 3e-4 of the leaf's scale;
    # the port is held tighter against its own float64 run
    (_, _), tg64 = ts.loss_and_grads(tm, tree_map(lambda a: a.double(), tp),
                                     {"tokens": torch.from_numpy(tok)})
    want, want64 = dict(leaves_with_path(_np(jg))), dict(leaves_with_path(tg64))
    for k, g in leaves_with_path(tg):
        s = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=3e-4 * s, err_msg=k)
        np.testing.assert_allclose(g.numpy(), want64[k].numpy(), rtol=1e-4, atol=5e-5 * s, err_msg=k)
    # the per-layer leaves share the params' storage, and nothing was written
    _assert_trees(tp, jp, dict(rtol=0, atol=0))


def test_head_ce_chunked_equals_unchunked_and_masks_negative_targets(granite):
    jm, tm, jp, tp = granite
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 21, tm.cfg.d_model)).astype(np.float32)
    tok = _tokens(3, (2, 21), tm.cfg.vocab)
    tok[0, 5:9] = -1
    tok[1, -1] = -1
    h, t = torch.from_numpy(hidden), torch.from_numpy(tok)
    full = tt.head_ce(tp, tm.cfg.replace(ce_chunk=0), h, t)
    for T in (8, 5, 20, 64):  # padded chunks, one chunk, no chunking
        np.testing.assert_allclose(float(tt.head_ce(tp, tm.cfg.replace(ce_chunk=T), h, t)),
                                   float(full), rtol=1e-6)
    # masked targets: the mean over the 35 valid next-token targets
    logits = tt.lm_logits(tp, tm.cfg, h[:, :-1]).double()
    lse = torch.logsumexp(logits, -1)
    tgt = t[:, 1:].long()
    valid = tgt >= 0
    pick = torch.gather(logits, -1, tgt.clamp(min=0)[..., None])[..., 0]
    want = float(((lse - pick) * valid).sum() / valid.sum())
    assert int(valid.sum()) == 35
    np.testing.assert_allclose(float(full), want, rtol=1e-5)
    jce = jt.head_ce(jp, jm.cfg, jnp.asarray(hidden), jnp.asarray(tok))
    np.testing.assert_allclose(float(full), float(jce), **FWD)


def _scenario(name):
    """The two scenarios of tests/test_steps.py: two separable groups over
    8 rounds, and one outlier among 8 clients."""
    rng = np.random.default_rng(0 if name == "groups" else 1)
    if name == "groups":
        d = 32
        a, b = rng.normal(size=d), rng.normal(size=d)
        rounds = [np.stack([(a if i % 2 == 0 else b) + 0.05 * rng.normal(size=d) for i in range(16)])
                  for _ in range(8)]
    else:
        d = 16
        base = rng.normal(size=d)
        sk = np.stack([base + 0.05 * rng.normal(size=d) for _ in range(8)])
        sk[3] = 40 * rng.normal(size=d)
        rounds = [sk]
    return d, [r.astype(np.float32) for r in rounds]


@pytest.mark.parametrize("name", ["groups", "outlier"])
def test_clustering_update_matches_jax(name):
    d, rounds = _scenario(name)
    js_state = js.clustering_init(2, d)
    ts_state = ts.clustering_init(2, d, device="cpu")
    for sk in rounds:
        js_state, jm = js.clustering_update(js_state, jnp.asarray(sk))
        ts_state, tm = ts.clustering_update(ts_state, torch.from_numpy(sk))
        np.testing.assert_array_equal(tm["assign"].numpy(), np.asarray(jm["assign"]))
        np.testing.assert_array_equal(tm["cluster_counts"].numpy(), np.asarray(jm["cluster_counts"]))
        for k in ("rewards", "dispersion"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-5)
        for k in js_state:
            np.testing.assert_allclose(ts_state[k].numpy(), np.asarray(js_state[k]), rtol=1e-5, atol=1e-5)
    if name == "groups":
        assign = tm["assign"].numpy()
        assert len(set(assign[::2])) == 1 and len(set(assign[1::2])) == 1 and assign[0] != assign[1]
    else:
        rw = tm["rewards"].numpy()
        assert rw[3] < 0 and rw[3] == rw.min()


def test_yogi_apply_matches_jax():
    rng = np.random.default_rng(4)

    def mk(s=1.0):
        return {"a": {"w": (s * rng.standard_normal((5, 7))).astype(np.float32)},
                "b": (s * rng.standard_normal(11)).astype(np.float32)}

    params, m, delta = mk(), mk(0.01), mk(0.01)
    v = mk(1e-4)
    v = {"a": {"w": np.abs(v["a"]["w"])}, "b": np.abs(v["b"])}
    delta["b"][:3] = 0.0  # Δ = 0
    v["b"][3:6] = delta["b"][3:6] * delta["b"][3:6]  # v = Δ²: sign(0) = 0
    jparams, jstate = js.yogi_apply(params, {"m": m, "v": v}, delta, lr=0.05)
    tparams = params_from_numpy(params, "cpu")
    tstate = params_from_numpy({"m": m, "v": v}, "cpu")
    out_p, out_s = ts.yogi_apply(tparams, tstate, params_from_numpy(delta, "cpu"), lr=0.05)
    assert out_p is tparams and out_s is tstate  # in place
    _assert_trees(out_p, jparams, dict(rtol=1e-6, atol=1e-7))
    _assert_trees(out_s, jstate, dict(rtol=1e-6, atol=1e-9))
    init = ts.yogi_init(tparams)
    _assert_trees(init, js.yogi_init(params), dict(rtol=0, atol=0))


@pytest.fixture(scope="module")
def sketched(granite):
    """Per-client deltas of the reduced granite (C = 3) and the JAX
    package's last-block sketches of them."""
    jm, tm, jp, _ = granite
    rng = np.random.default_rng(5)
    deltas = jax.tree.map(lambda a: (0.01 * rng.standard_normal((3,) + a.shape)).astype(np.float32),
                          _np(jp))
    want = np.asarray(jax.vmap(JSketcher(d_sketch=32, strategy="last_block_proj"))(
        jax.tree.map(jnp.asarray, deltas)))
    return deltas, want


@pytest.mark.parametrize("cached", [True, False])
def test_last_block_sketch_matches_jax(sketched, monkeypatch, cached):
    deltas, want = sketched
    if not cached:  # the streaming path the full-width block takes
        monkeypatch.setattr(tsketch, "CACHE_FLOATS", 0)
    sk = tsketch.GradientSketcher(d_sketch=32, strategy="last_block_proj")
    got = sk.batch(params_from_numpy(deltas, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # selection: the final norm and every backbone leaf's last-layer slice
    picked = [k for k, _ in sk._selected(params_from_numpy(deltas, "cpu"))]
    assert "['final_norm']['scale']" in picked and "['embed']" not in picked
    assert len(picked) == 10 and len(sk._blocks) == (10 if cached else 0)


def _rounds(step, params, opt, clust, batches):
    out = []
    for b in batches:
        params, opt, clust, met = step(params, opt, clust, b)
        out.append(met)
    return params, opt, clust, out


def test_train_step_matches_jax_over_three_rounds(granite):
    jm, tm, jp, _ = granite
    sc_j = js.StepConfig(local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32)
    sc_t = ts.StepConfig(local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32)
    toks = [_tokens(10 + r, (4, 4, 16), jm.cfg.vocab) for r in range(3)]
    # the jitted step donates what it is given: hand it a copy
    jres = _rounds(js.jit_train_step(js.make_train_step(jm, sc_j)), jax.tree.map(jnp.copy, jp),
                   js.yogi_init(jp),
                   js.clustering_init(2, 32), [{"tokens": jnp.asarray(t)} for t in toks])
    tp = _carry(jp)
    tres = _rounds(ts.jit_train_step(ts.make_train_step(tm, sc_t)), tp, ts.yogi_init(tp),
                   ts.clustering_init(2, 32, device="cpu"), [{"tokens": torch.from_numpy(t)} for t in toks])
    for name, got, want in zip(("params", "opt", "clust"), tres[:3], jres[:3]):
        want = dict(leaves_with_path(_np(want)))
        for k, g in leaves_with_path(got):
            np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=1e-5 + F32_FLOOR[name],
                                       err_msg=name + " " + k)
    for tmet, jmet in zip(tres[3], jres[3]):
        np.testing.assert_array_equal(tmet["cluster_counts"].numpy(), np.asarray(jmet["cluster_counts"]))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **STEP)
        for k in ("dispersion", "reward_mean"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                       atol=1e-5 + F32_FLOOR["metrics"], err_msg=k)


def test_federated_train_step_improves_loss(granite):
    """tests/test_steps.py's assertion, on the port."""
    jm, tm, _, _ = granite
    from repro_torch import random as rnd

    sc = ts.StepConfig(local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32)
    step = ts.make_train_step(tm, sc)
    params = tm.init(rnd.key(0), device="cpu")
    opt, clust = ts.yogi_init(params), ts.clustering_init(sc.cluster_k, sc.d_sketch, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(0, (4, 4, 16), tm.cfg.vocab))}
    losses = []
    for _ in range(16):
        params, opt, clust, metrics = step(params, opt, clust, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses
    assert float(clust["initialized"]) == 1.0
    assert float(metrics["cluster_counts"].sum()) == 4


def test_central_train_step_matches_jax(granite):
    jm, tm, jp, _ = granite
    sc_j = js.StepConfig(server_lr=0.2, d_sketch=32)
    sc_t = ts.StepConfig(server_lr=0.2, d_sketch=32)
    toks = [_tokens(20 + r, (8, 16), jm.cfg.vocab) for r in range(2)]
    jres = _rounds(jax.jit(js.make_central_train_step(jm, sc_j, n_clients=4)), jp, js.yogi_init(jp),
                   js.clustering_init(2, 32), [{"tokens": jnp.asarray(t)} for t in toks])
    tp = _carry(jp)
    tres = _rounds(ts.make_central_train_step(tm, sc_t, n_clients=4), tp, ts.yogi_init(tp),
                   ts.clustering_init(2, 32, device="cpu"), [{"tokens": torch.from_numpy(t)} for t in toks])
    for name, got, want in zip(("params", "opt", "clust"), tres[:3], jres[:3]):
        _assert_trees(got, want, STEP, name + " ")
    for tmet, jmet in zip(tres[3], jres[3]):
        np.testing.assert_array_equal(tmet["cluster_counts"].numpy(), np.asarray(jmet["cluster_counts"]))
        for k in ("loss", "dispersion", "reward_mean"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **STEP)


@pytest.mark.parametrize("arch,steps", [("granite_3_2b", 6), ("h2o_danube_3_4b", 14)])
def test_prefill_and_serve_match_jax(arch, steps):
    """Prefill logits, then decode steps against the cache; h2o-danube's
    reduction has an 8-token sliding window, so its ring wraps."""
    jm, tm = _models(arch)
    jp = jm.init(jax.random.key(6))
    tp = _carry(jp)
    tok = _tokens(6, (2, 16), jm.cfg.vocab)
    jpre = js.make_prefill_step(jm, js.StepConfig())(jp, {"tokens": jnp.asarray(tok)})
    tpre = ts.make_prefill_step(tm, ts.StepConfig())(tp, {"tokens": torch.from_numpy(tok)})
    assert tuple(tpre.shape) == (2, 1, tm.cfg.vocab)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **FWD)
    jserve = jax.jit(js.make_serve_step(jm, js.StepConfig()))
    tserve = ts.make_serve_step(tm, ts.StepConfig())
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32, device="cpu")
    ring = 8 if tm.cfg.sliding_window else 32
    assert tuple(tc["blocks"]["k"].shape) == (2, 2, ring, tm.cfg.n_kv_heads, tm.cfg.hd)
    for i in range(steps):
        cur = tok[:, i % 16:i % 16 + 1]
        jl, jc = jserve(jp, jc, {"tokens": jnp.asarray(cur)})
        tl, tc = tserve(tp, tc, {"tokens": torch.from_numpy(cur)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **FWD)
        assert bool(torch.isfinite(tl).all())
    np.testing.assert_array_equal(tc["blocks"]["index"].numpy(), np.asarray(jc["blocks"]["index"]))
    for k in ("k", "v"):  # projections of |x| up to ~20: 2e-5 of their scale
        want = np.asarray(jc["blocks"][k])
        np.testing.assert_allclose(tc["blocks"][k].numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


def test_transformer_task_matches_jax(granite):
    jm, tm, jp, tp = granite
    tok = _tokens(7, (3, 16), jm.cfg.vocab)
    tok[:, 8:] = tok[:, :8]  # a repeat, so some next tokens are predictable
    jtask, ttask = JTask(jm), TTask(tm)
    np.testing.assert_allclose(float(ttask.loss(tp, (torch.from_numpy(tok), None))),
                               float(jtask.loss(jp, (jnp.asarray(tok), None))), **FWD)
    np.testing.assert_allclose(float(ttask.loss(tp, torch.from_numpy(tok))),
                               float(jtask.loss(jp, jnp.asarray(tok))), **FWD)
    assert ttask.accuracy(tp, torch.from_numpy(tok)) == pytest.approx(
        jtask.accuracy(jp, jnp.asarray(tok)), abs=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_pytree_of_a_jax_npz(tmp_path, granite, dtype):
    jm, tm, jp, tp = granite
    jtree = {"params": jp, "clust": js.clustering_init(2, 8)}
    if dtype == "bfloat16":
        jtree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree)
    jsave(tmp_path / "j.npz", jtree)
    like = {"params": tree_map(torch.zeros_like, tp), "clust": ts.clustering_init(2, 8, device="cpu")}
    if dtype == "bfloat16":
        like = tree_map(lambda a: a.to(torch.bfloat16), like)
    got = load_pytree(tmp_path / "j.npz", like)
    want = dict(leaves_with_path(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree)))
    for k, v in leaves_with_path(got):
        assert v.dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=k)
    # and back: a port-written file loads into the JAX package bit for bit
    save_pytree(tmp_path / "t.npz", got)
    back = jload(tmp_path / "t.npz", jtree)
    for (k, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(jtree)):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32)))
    with pytest.raises(KeyError):
        load_pytree(tmp_path / "j.npz", {"other": torch.zeros(1)})


def test_launch_train_on_the_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--rounds", "2", "--d-model", "64", "--layers", "2", "--vocab", "128",
            "--seq", "16", "--clients", "4", "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path)]
    params, opt, clust, metrics = ttrain.main(argv)
    out = capsys.readouterr().out
    assert "round    0 loss" in out and "round    1 loss" in out and "checkpointed at round 1" in out
    assert np.isfinite(float(metrics["loss"])) and float(metrics["cluster_counts"].sum()) == 4
    assert all(bool(torch.isfinite(a).all()) for _, a in leaves_with_path(params))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["clust.npz", "opt.npz", "params.npz"]
    # resume: the checkpoint restores the state it saved
    p2, _, c2, _ = ttrain.main(argv[:3] + ["0"] + argv[4:] + ["--resume"])
    for (k, a), (_, b) in zip(leaves_with_path(p2), leaves_with_path(params)):
        assert torch.equal(a, b), k
    assert torch.equal(c2["centroids"], clust["centroids"])
