"""The port's MoE family (``repro_torch.models.moe``, the MoE backbones of
``models/transformer.py``, their training steps and the train driver)
against the JAX package, in one process.

Inputs come from numpy seeds; JAX params go across with
``convert.params_from_numpy``. Discrete outputs (top-k ids, keep masks,
dropped shares, cluster assignments and counts) are equal; floats agree at
rtol 1e-4 / atol 1e-5, or at ``F32_FLOOR`` (tests/test_torch_lm_train.py)
where XLA's float32 error is larger; bf16 at bf16's resolution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.launch import steps as js
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch import random as rnd
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as ts
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.utils.tree import leaves_with_path, tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)  # a few bf16 ulps (8 mantissa bits)
# tests/test_torch_lm_train.py's allowance for float32's own error over
# whole train steps (twice the float32-vs-float64 error measured there)
F32_FLOOR = {"params": 1e-4, "opt": 0.0, "clust": 2e-3, "metrics": 1.5e-3}
MOE = ["qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b"]
# the reduced llama4's logits carry float32's own error of up to 1.21e-4
# (JAX) and 7.9e-5 (the port) against a float64 run of the port, from
# the residual stream before its first MoE layer (routing equal in both):
# twice that is allowed on top of TOL's atol; qwen3-moe's is 8e-7
LOGIT_FLOOR = {"qwen3_moe_235b_a22b": 0.0, "llama4_maverick_400b_a17b": 2.5e-4}


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


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a),
                        tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_keep(cfg, weights, ids, tg):
    """The JAX package's keep mask (moe.py:80-84), from its own route."""
    G = ids.shape[0]
    oh = jax.nn.one_hot(ids, cfg.n_experts, dtype=jnp.int32).reshape(G, tg * cfg.top_k, cfg.n_experts)
    pos = ((jnp.cumsum(oh, axis=1) - 1) * oh).sum(-1).reshape(G, tg, cfg.top_k)
    return np.asarray((pos < jmoe._capacity(tg, cfg)) & (weights > 0))


def _moe_params(jcfg, tcfg, seed):
    """JAX MoE params and the port's copy; bf16 leaves go across through
    float32 (exact), the router stays float32."""
    jp = jmoe.moe_init(jax.random.key(seed), jcfg)
    tp = tree_map(lambda a: a.to(tcfg.dtype), params_from_numpy(_np(jp), "cpu"))
    tp["router"] = tp["router"].float()
    return jp, tp


@pytest.mark.parametrize("tg,top_k,cf", [(1, 8, 1.25), (16, 2, 1.25), (256, 8, 1.25), (256, 1, 2.0),
                                         (64, 2, 0.5), (7, 3, 1.0), (4096, 8, 1.25)])
def test_capacity_matches_jax(tg, top_k, cf):
    jcfg, tcfg = _cfgs("qwen3_moe_235b_a22b", top_k=top_k, capacity_factor=cf, n_experts=128)
    assert tmoe._capacity(tg, tcfg) == jmoe._capacity(tg, jcfg)
    if (tg, top_k) == (256, 8):
        assert tmoe._capacity(tg, tcfg) == 24  # the full-width group: 20 -> 24


def test_route_ties_take_the_lowest_index():
    """A zero router: every probability ties, so top-k is experts 0..k-1
    on every token (jax.lax.top_k's rule), with equal weights."""
    jcfg, tcfg = _cfgs("qwen3_moe_235b_a22b", n_experts=8, top_k=3)
    x = _x(0, (2, 5, jcfg.d_model))
    jw, jids, jaux = jmoe.route({"router": jnp.zeros((jcfg.d_model, 8))}, jcfg, jnp.asarray(x))
    tw, tids, taux = tmoe.route({"router": torch.zeros(tcfg.d_model, 8)}, tcfg, torch.from_numpy(x))
    assert np.array_equal(np.asarray(jids), np.broadcast_to(np.arange(3), (2, 5, 3)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL)


def test_route_matches_jax():
    jcfg, tcfg = _cfgs("qwen3_moe_235b_a22b", n_experts=16, top_k=4)
    jp, tp = _moe_params(jcfg, tcfg, 1)
    x = _x(1, (3, 32, jcfg.d_model))
    jw, jids, jaux = jmoe.route(jp, jcfg, jnp.asarray(x))
    tw, tids, taux = tmoe.route(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_with_drops_matches_jax(arch, dtype):
    """A group of 32 tokens at capacity factor 0.5 (cap 8 of 32): equal keep
    masks and dropped shares (> 0), outputs within tolerance. llama4 adds
    its shared expert."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jcfg, tcfg = _cfgs(arch, moe_group=32, capacity_factor=0.5, dtype=jdt)
    tcfg = tcfg.replace(dtype=tdt)
    jp, tp = _moe_params(jcfg, tcfg, 2)
    x = _x(2, (2, 64, jcfg.d_model))
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx)
    ty, taux = tmoe.moe_apply(tp, tcfg, tx)
    assert ty.dtype == tdt and tuple(ty.shape) == jy.shape
    # keep masks: the port's dispatch against the JAX package's positions
    jw, jids, _ = jmoe.route(jp, jcfg, jx.reshape(4, 32, -1))
    tw, tids, _ = tmoe.route(tp, tcfg, tx.reshape(4, 32, -1))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _, _, keep = tmoe.dispatch(tcfg, tx.reshape(1, 4, 32, -1), tw[None], tids[None])
    jkeep = _jax_keep(jcfg, jw, jids, 32)
    np.testing.assert_array_equal(keep[0].numpy(), jkeep)
    assert 0 < float(taux["frac_dropped"]) == float(jaux["frac_dropped"])
    np.testing.assert_allclose(float(taux["frac_dropped"]), 1 - jkeep.mean(), rtol=1e-6)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL)
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), want, **(TOL if dtype == "float32" else BF16))
    # a dropped choice adds nothing: a token with every choice dropped gets
    # zero from the routed experts
    if not jcfg.shared_expert:
        none_kept = ~jkeep.any(-1).reshape(2, 64)
        assert none_kept.any()
        assert float(ty.float()[torch.from_numpy(none_kept)].abs().max()) == 0.0


def test_moe_apply_rejects_a_ragged_group():
    _, tcfg = _cfgs("qwen3_moe_235b_a22b")
    tp = tmoe.moe_init(rnd.key(0), tcfg)
    with pytest.raises(ValueError, match="routing group"):
        tmoe.moe_apply(tp, tcfg, torch.zeros(1, 20, tcfg.d_model))  # moe_group 16


@pytest.mark.parametrize("arch", MOE)
def test_stacked_rows_match_vmap(arch):
    """Params (R, E, D, F) and x (R, B, S, D): each row with its own
    weights, as jax.vmap(moe_apply); aux terms per row."""
    jcfg, tcfg = _cfgs(arch, moe_group=16, capacity_factor=1.0)
    jps = [jmoe.moe_init(jax.random.key(s), jcfg) for s in (3, 4)]
    jp = jax.tree.map(lambda *a: jnp.stack(a), *jps)
    tp = params_from_numpy(_np(jp), "cpu")
    x = _x(3, (2, 2, 32, jcfg.d_model))
    jy, jaux = jax.vmap(lambda p, xx: jmoe.moe_apply(p, jcfg, xx))(jp, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in jaux:
        assert tuple(taux[k].shape) == (2,)
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), **TOL)
    for r in range(2):  # and each row equals the unstacked call
        y, _ = tmoe.moe_apply(tree_map(lambda a: a[r], tp), tcfg, torch.from_numpy(x[r]))
        torch.testing.assert_close(ty[r], y, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """Reduced qwen3-moe and llama4 (chunked attention and CE; a routing
    group of 8 tokens, so that S = 16 makes two groups a sequence), their
    JAX params and the port's copies."""
    out = {}
    for arch in MOE:
        jcfg, tcfg = _cfgs(arch, attn_qchunk=8, ce_chunk=8, moe_group=8)
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        jp = jax.jit(jm.init)(jax.random.key(5))  # the same draws as eager, compiled once
        out[arch] = (jm, tm, jp, params_from_numpy(_np(jp), "cpu"))
    return out


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_jax(models, arch):
    jm, tm, jp, tp = models[arch]
    tok = _tokens(6, (2, 16), jm.cfg.vocab)
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(tok)}),
                                        has_aux=True)(jp)
    (tl, tmet), tg = ts.loss_and_grads(tm, tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k in ("ce", "lb_loss", "z_loss"):
        assert float(jmet[k]) > 0
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    # XLA's float32 CPU gradients sit up to ~2e-4 of each leaf's scale from
    # float64 (tests/test_torch_lm_train.py): rtol 1e-4 plus 3e-4 of it
    want = dict(leaves_with_path(_np(jg)))
    assert [k for k, _ in leaves_with_path(tg)] == [k for k, _ in leaves_with_path(tp)]
    for k, g in leaves_with_path(tg):
        s = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=3e-4 * s, err_msg=k)
    assert float(np.abs(want["['backbone']['moe_blocks']['moe']['router']" if "moe_blocks" in jp["backbone"]
                             else "['backbone']['blocks']['moe']['router']"]).max()) > 0


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_decode_chain_match_jax(models, arch):
    """The teacher-forced forward, then 6 decode steps against the cache."""
    jm, tm, jp, tp = models[arch]
    tok = _tokens(7, (2, 16), jm.cfg.vocab)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
    tol = dict(rtol=1e-4, atol=1e-5 + LOGIT_FLOOR[arch])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    assert sorted(tc) == sorted(jc)
    jstep = jax.jit(jm.decode_step)
    for i in range(6):
        jd, jc = jstep(jp, jnp.asarray(tok[:, i:i + 1]), jc)
        td, tc = tm.decode_step(tp, torch.from_numpy(tok[:, i:i + 1]), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"step {i}", **tol)
    for name in jc:
        np.testing.assert_array_equal(tc[name]["index"].numpy(), np.asarray(jc[name]["index"]))
        want = np.asarray(jc[name]["k"])  # projections up to ~20: 2e-5 of their scale
        np.testing.assert_allclose(tc[name]["k"].numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


def _rounds(step, state, batches, snap):
    """Run ``step`` over the batches; after each, float64 numpy copies of
    (params, opt, clust) and the metrics."""
    out = []
    for b in batches:
        *state, met = step(*state, b)
        out.append(([snap(t) for t in state], met))
    return out


def _jax_snap(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def _port_snap(tree):
    return tree_map(lambda a: a.detach().double().clone().numpy(), tree)


def _held(tres, jres, floors):
    """Every round's state and metrics against the JAX package's, at
    rtol 1e-4 / atol 1e-5 plus that round's floor per tree."""
    for r, ((tstate, tmet), (jstate, jmet), floor) in enumerate(zip(tres, jres, floors)):
        for name, got, want in zip(("params", "opt", "clust"), tstate, jstate):
            want = dict(leaves_with_path(want))
            for k, g in leaves_with_path(got):
                np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5 + floor[name],
                                           err_msg=f"round {r} {name} {k}")
        np.testing.assert_array_equal(tmet["cluster_counts"].numpy(), np.asarray(jmet["cluster_counts"]))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
        for k in ("dispersion", "reward_mean"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                       atol=1e-5 + floor["metrics"], err_msg=f"round {r} {k}")


# llama4's third federated round: FedYoGi's sign(v - d^2) amplifies float32's
# rounding from round to round (no routing decision differs), so its own
# error against a float64 run of the port grows to params 4.27e-3, opt
# 1.73e-4, centroids 0.035, dispersion 0.060 (JAX; the port's: 4.51e-3,
# 1.84e-4, 0.038, 0.064). Twice that is allowed in that round; the first
# two rounds (own error at most 8.8e-5 on params) hold at F32_FLOOR.
LLAMA4_ROUND3 = {"params": 9e-3, "opt": 3.5e-4, "clust": 0.07, "metrics": 0.12}


@pytest.mark.parametrize("arch", MOE)
def test_federated_steps_match_jax(models, arch):
    """Three rounds of make_train_step (mode A): 4 clients x 4 sequences."""
    jm, tm, jp, _ = models[arch]
    sc = dict(local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32)
    toks = [_tokens(10 + r, (4, 4, 16), jm.cfg.vocab) for r in range(3)]
    jres = _rounds(js.jit_train_step(js.make_train_step(jm, js.StepConfig(**sc))),
                   [jax.tree.map(jnp.copy, jp), js.yogi_init(jp), js.clustering_init(2, 32)],
                   [{"tokens": jnp.asarray(t)} for t in toks], _jax_snap)
    tp = params_from_numpy(_np(jp), "cpu")
    tres = _rounds(ts.make_train_step(tm, ts.StepConfig(**sc)),
                   [tp, ts.yogi_init(tp), ts.clustering_init(2, 32, device="cpu")],
                   [{"tokens": torch.from_numpy(t)} for t in toks], _port_snap)
    last = LLAMA4_ROUND3 if arch.startswith("llama4") else F32_FLOOR
    _held(tres, jres, [F32_FLOOR, F32_FLOOR, last])


@pytest.mark.parametrize("arch", MOE)
def test_central_steps_match_jax(models, arch):
    """Two steps of make_central_train_step (mode B), 4 clients of 2."""
    jm, tm, jp, _ = models[arch]
    sc = dict(server_lr=0.2, d_sketch=32)
    toks = [_tokens(20 + r, (8, 16), jm.cfg.vocab) for r in range(2)]
    jres = _rounds(jax.jit(js.make_central_train_step(jm, js.StepConfig(**sc), n_clients=4)),
                   [jp, js.yogi_init(jp), js.clustering_init(2, 32)],
                   [{"tokens": jnp.asarray(t)} for t in toks], _jax_snap)
    tp = params_from_numpy(_np(jp), "cpu")
    tres = _rounds(ts.make_central_train_step(tm, ts.StepConfig(**sc), n_clients=4),
                   [tp, ts.yogi_init(tp), ts.clustering_init(2, 32, device="cpu")],
                   [{"tokens": torch.from_numpy(t)} for t in toks], _port_snap)
    _held(tres, jres, [dict.fromkeys(F32_FLOOR, 0.0)] * 2)


def test_launch_train_moe_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--arch", "qwen3-moe-235b-a22b", "--rounds", "1", "--d-model", "16",
            "--layers", "2", "--vocab", "128", "--seq", "16", "--clients", "2"]
    params, opt, clust, metrics = ttrain.main(argv)
    out = capsys.readouterr().out
    assert "qwen3-moe-235b-a22b" in out and "round    0 loss" in out
    assert np.isfinite(float(metrics["loss"])) and float(metrics["cluster_counts"].sum()) == 2
    assert tuple(params["backbone"]["blocks"]["moe"]["wg"].shape) == (2, 128, 16, 64)
    assert all(bool(torch.isfinite(a).all()) for _, a in leaves_with_path(params))
