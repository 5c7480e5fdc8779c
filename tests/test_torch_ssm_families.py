"""The port's SSM and hybrid families (xlstm-1.3b: mLSTM + sLSTM groups;
zamba2-7b: Mamba-2 superblocks around one shared attention block) against
the JAX package, in one process: inits and bank slots, parameter counts,
the forward pass, the loss and its gradients in the params' nested layout,
decode caches, the last-block sketch, ``TransformerTask``, the federated
and central train steps and the train driver.

Reduced configs (``reduce_config``: d 256, 2 layers, ``ssm_chunk`` 16);
zamba2 also as 5 layers at ``attn_every`` 2 (``+tail``: two superblocks,
the shared block applied twice, one tail layer). Inputs come from numpy
seeds; JAX params go across with ``convert.params_from_numpy``. Counts and
discrete outputs are equal; floats agree at rtol 1e-4 / atol 1e-5 (forward
logits at tests/test_torch_lm_train.py's 2e-5), gradients with
tests/test_torch_families.py's allowance for XLA's float32 error (3e-4 of
each leaf's scale), or at twice float32's own error measured against a
float64 run of the port where that is larger (the constants below).
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
from repro_torch import random as rnd
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.core.sketch import GradientSketcher as TSketcher
from repro_torch.fl.task import TransformerTask as TTask
from repro_torch.launch import steps as ts
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer
from repro_torch.utils.tree import leaves, leaves_with_path, tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=2e-5, atol=2e-5)
# the models: (arch, overrides of the reduced config); zamba2's "+tail"
# variant has a tail layer and applies the shared block twice
MODELS = {
    "xlstm_1_3b": ("xlstm_1_3b", {}),
    "zamba2_7b": ("zamba2_7b", {}),
    "zamba2_7b+tail": ("zamba2_7b", {"n_layers": 5, "attn_every": 2}),
}
# The reduced zamba2's shared attention is nearly one-hot (the reference's
# fan-in of (D, H, hd) projections is H) and lifts the residual stream to
# ~80-110, so a near tie between two keys magnifies float32's rounding.
# Measured against a float64 run of the port on each test's inputs, the
# float32 error (JAX / the port) reaches: logits 3.0e-4 / 1.19e-3 (zamba2),
# 4.8e-4 / 5.0e-4 (+tail); gradients 1.08e-3 / 4.26e-3 and 8.3e-4 /
# 2.06e-3 of a leaf's largest |g|; after 6 decode steps (+tail) logits
# 4.5e-5 / 2.9e-4 and caches 5.2e-5 / 3.4e-4 of max(1, the leaf's scale).
# Twice the larger is allowed (logits on top of FWD's atol, gradients as a
# share of the leaf's scale in place of 3e-4). xlstm's own error stays
# inside FWD (logits 9.2e-6 / 7.5e-6) and 3e-4 (gradients 2.3e-5 /
# 1.7e-5).
LOGIT_FLOOR = {"xlstm_1_3b": 0.0, "zamba2_7b": 2.4e-3, "zamba2_7b+tail": 1.0e-3}
GRAD_FLOOR = {"xlstm_1_3b": 3e-4, "zamba2_7b": 8.6e-3, "zamba2_7b+tail": 4.2e-3}
CACHE_FLOOR = {"xlstm_1_3b": 1e-4, "zamba2_7b": 1e-4, "zamba2_7b+tail": 6.8e-4}
# tests/test_torch_lm_train.py's allowance for float32's own error over
# whole train steps (twice the float32-vs-float64 error measured there)
F32_FLOOR = {"params": 1e-4, "opt": 0.0, "clust": 2e-3, "metrics": 1.5e-3}
# the train steps' own float32 error against a float64 run of the port,
# where it passes F32_FLOOR (FedYoGi's sign(v - d^2) amplifies it from
# round to round; no assignment differs): zamba2's federated rounds
# (JAX / port) params 1.7e-5 / 2.8e-5, 3.5e-3 / 4.0e-3, 6.6e-3 / 7.5e-3;
# opt -, 1.4e-4 / 1.6e-4, 1.7e-4 / 2.5e-4; centroids 4.8e-3 / 4.4e-3,
# 0.018 / 0.021, 0.111 / 0.100; dispersion and reward 6.5e-4 / 2.5e-4,
# 9.2e-3 / 0.022, 0.066 / 0.118; zamba2+tail's second central step params
# 2.9e-4 / 8.6e-4, opt 2.8e-6 / 8.6e-6, centroids 4.5e-6 / 7.1e-6, metrics
# 2.8e-6 / 6.3e-6; the mean loss of zamba2's third federated round 4.4e-4
# / 1.12e-3. Twice the larger is allowed in those rounds; xlstm's
# (at most params 9.0e-5, centroids 7.8e-4, metrics 1.4e-3) pass F32_FLOOR.
FED_FLOORS = {
    "xlstm_1_3b": [F32_FLOOR] * 3,
    "zamba2_7b": [dict(F32_FLOOR, clust=9.6e-3),
                  {"params": 7.9e-3, "opt": 3.2e-4, "clust": 0.042, "metrics": 0.043},
                  {"params": 0.015, "opt": 5.1e-4, "clust": 0.22, "metrics": 0.24, "loss": 2.3e-3}],
}
NO_FLOOR = dict.fromkeys(F32_FLOOR, 0.0)
CENTRAL_FLOORS = {
    "xlstm_1_3b": [NO_FLOOR] * 2,
    "zamba2_7b+tail": [NO_FLOOR, {"params": 1.7e-3, "opt": 1.7e-5, "clust": 1.4e-5, "metrics": 1.3e-5}],
}
S = 32  # tokens per sequence: two SSD chunks of 16


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


def _cfgs(name, **kw):
    arch, over = MODELS[name]
    kw = dict(over, attn_qchunk=8, ce_chunk=8, **kw)
    return jreduce(jget(arch)).replace(**kw), treduce(tget(arch)).replace(**kw)


@pytest.fixture(scope="module")
def models():
    """Each model's JAX and port handles and params (from the same JAX
    init), built once for the module."""
    out = {}
    for name in MODELS:
        jcfg, tcfg = _cfgs(name)
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        jp = jax.jit(jm.init)(jax.random.key(5))
        out[name] = (jm, tm, jp, params_from_numpy(_np(jp), "cpu"))
    return out


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_init_and_bank_slot_match_jax(name):
    """Same keys, same threefry draws: every leaf within 1e-6 (erfinv's last
    bits; A_log's log), the same nested stacks and shapes; a bank slot is
    init(fold_in(key, i)), drawn in place."""
    jcfg, tcfg = _cfgs(name)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    want = dict(leaves_with_path(_np(jax.jit(jm.init)(jax.random.key(11)))))
    got = dict(leaves_with_path(tm.init(rnd.key(11), device="cpu")))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
    bank = dict(leaves_with_path(tm.init_bank(rnd.key(11), 2, device="cpu")))
    slot1 = dict(leaves_with_path(tm.init(rnd.fold_in(rnd.key(11), 1), device="cpu")))
    assert all(torch.equal(bank[k][1], slot1[k]) for k in slot1)


@pytest.mark.parametrize("arch,n", [("xlstm_1_3b", 2_019_633_152), ("zamba2_7b", 6_750_539_856)])
def test_param_counts_match_jax(arch, n):
    """The full configs on the meta device (no storage), and their stacks."""
    tm = tbuild(tget(arch))
    assert tm.param_count() == jbuild(jget(arch)).param_count() == n
    shapes = tm.init_shapes()["backbone"]
    if arch.startswith("xlstm"):
        assert transformer.block_stacks(tm.cfg) == {"mlstm": (6, 7), "slstm": (6,)}
        assert tuple(shapes["mlstm"]["w_up"].shape) == (6, 7, 2048, 8192)
    else:
        assert transformer.block_stacks(tm.cfg) == {"mamba": (13, 6), "mamba_tail": (3,), "shared_attn": ()}
        assert tuple(shapes["mamba"]["w_in"].shape) == (13, 6, 3584, 14576)
        assert tuple(shapes["shared_attn"]["attn"]["wq"].shape) == (3584, 32, 112)
        # depth 39 keeps the superblock shape: 6 of 6 layers and the 3-layer tail
        cut = tbuild(tget(arch).replace(n_layers=39))
        assert transformer.block_stacks(cut.cfg) == {"mamba": (6, 6), "mamba_tail": (3,), "shared_attn": ()}
        assert cut.param_count() == 3_475_767_600


def _grads_held(tg, jg, name):
    want = dict(leaves_with_path(_np(jg)))
    assert [k for k, _ in leaves_with_path(tg)] == sorted(want)
    for k, g in leaves_with_path(tg):
        s = float(np.abs(want[k]).max())
        assert tuple(g.shape) == want[k].shape, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=GRAD_FLOOR[name] * s, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_grads_match_jax(models, name):
    """Logits over (2, 32) tokens, the loss (lb and z zero), and per-leaf
    gradients in the nested layout (the shared block's summed over its
    applications)."""
    jm, tm, jp, tp = models[name]
    tok = _tokens(6, (2, S), jm.cfg.vocab)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    jl, _ = jm.forward(jp, jb)
    tl, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD["rtol"], atol=FWD["atol"] + LOGIT_FLOOR[name])
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True))(jp)
    (tloss, tmet), tg = ts.loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), **FWD)
    assert float(tmet["lb_loss"]) == float(tmet["z_loss"]) == 0.0
    _grads_held(tg, jg, name)
    if "tail" in name:
        assert float(tg["backbone"]["mamba_tail"]["w_in"].abs().max()) > 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_chain_matches_jax(models, name):
    """init_cache, then 6 tokens through decode_step: logits and every
    cache leaf (recurrent states, the shared block's KV caches per
    application, their indices) against JAX's."""
    jm, tm, jp, tp = models[name]
    tok = _tokens(7, (2, 6), jm.cfg.vocab)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    assert [k for k, _ in leaves_with_path(tc)] == [k for k, _ in leaves_with_path(_np(jc))]
    jstep = jax.jit(jm.decode_step)
    tol = dict(rtol=1e-4, atol=1e-5 + LOGIT_FLOOR[name])
    for i in range(6):
        jd, jc = jstep(jp, jnp.asarray(tok[:, i:i + 1]), jc)
        td, tc = tm.decode_step(tp, torch.from_numpy(tok[:, i:i + 1]), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"step {i}", **tol)
    want = dict(leaves_with_path(_np(jc)))
    for k, v in leaves_with_path(tc):
        assert tuple(v.shape) == want[k].shape, k
        if "index" in k:
            np.testing.assert_array_equal(v.numpy(), want[k])
        else:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4,
                                       atol=CACHE_FLOOR[name] * max(1.0, np.abs(want[k]).max()), err_msg=k)
    if "attn" in tc:
        assert tc["attn"]["index"].tolist() == [6] * tc["attn"]["index"].shape[0]


@pytest.mark.parametrize("name", ["xlstm_1_3b", "zamba2_7b+tail"])
def test_last_block_sketch_matches_jax(name):
    """Per-client deltas: the selection is the final norm, the head and
    l[-1] of every backbone leaf with >= 2 dims: the whole last superblock
    or group of a nested stack, the last tail layer, and the first weight
    axis of the shared block's unstacked leaves (its 1-D norms skipped),
    in JAX's sorted leaf order; the sketches equal JAX's."""
    jcfg, tcfg = _cfgs(name, d_model=64, vocab=128)
    jm = jbuild(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    rng = np.random.default_rng(5)
    deltas = jax.tree.map(lambda a: (0.01 * rng.standard_normal((2,) + a.shape)).astype(np.float32), shapes)
    jdeltas = jax.tree.map(jnp.asarray, deltas)
    want = np.asarray(jax.jit(jax.vmap(JSketcher(d_sketch=16, strategy="last_block_proj")))(jdeltas))
    sk = TSketcher(d_sketch=16, strategy="last_block_proj")
    tdeltas = params_from_numpy(deltas, "cpu")
    np.testing.assert_allclose(sk.batch(tdeltas).numpy(), want, rtol=1e-5, atol=1e-5)
    jpicked = JSketcher(d_sketch=16, strategy="last_block_proj")._selected(jax.tree.map(lambda a: a[0], jdeltas))
    picked = sk._selected(tdeltas)
    assert [k for k, _ in picked] == [k for k, _ in jpicked]
    assert [tuple(l.shape[1:]) for _, l in picked] == [l.shape for _, l in jpicked]
    got = dict((k, tuple(l.shape[1:])) for k, l in picked)
    if name.startswith("xlstm"):
        assert got["['backbone']['mlstm']['w_up']"] == (1, 64, 256)  # the last group's g - 1 = 1 layer
        assert got["['backbone']['slstm']['r']"] == (4, 4, 16, 16)
    else:
        d_in = tdeltas["backbone"]["mamba"]["w_in"].shape
        assert got["['backbone']['mamba']['w_in']"] == tuple(d_in[2:])  # the last superblock
        assert got["['backbone']['shared_attn']['attn']['wq']"] == (4, 16)  # wq (D, H, hd)[-1]
        assert "['backbone']['shared_attn']['attn_norm']['scale']" not in got
        if "tail" in name:
            assert got["['backbone']['mamba_tail']['A_log']"] == (8,)


@pytest.mark.parametrize("name", ["xlstm_1_3b", "zamba2_7b"])
def test_transformer_task_matches_jax(models, name):
    """TransformerTask's loss and next-token accuracy."""
    jm, tm, jp, tp = models[name]
    tok = _tokens(8, (3, S), jm.cfg.vocab)
    tok[:, 16:] = tok[:, :16]
    jtask, ttask = JTask(jm), TTask(tm)
    np.testing.assert_allclose(float(ttask.loss(tp, (torch.from_numpy(tok), None))),
                               float(jtask.loss(jp, (jnp.asarray(tok), None))), **FWD)
    assert ttask.accuracy(tp, torch.from_numpy(tok)) == pytest.approx(jtask.accuracy(jp, jnp.asarray(tok)), abs=1e-6)


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
    rtol 1e-4 / atol 1e-5 plus that round's floor per tree (and for the
    loss where a floor names it); the cluster
    counts (and so the assignments) equal."""
    for r, ((tstate, tmet), (jstate, jmet), floor) in enumerate(zip(tres, jres, floors)):
        for name, got, want in zip(("params", "opt", "clust"), tstate, jstate):
            want = dict(leaves_with_path(want))
            for k, g in leaves_with_path(got):
                np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5 + floor[name],
                                           err_msg=f"round {r} {name} {k}")
        np.testing.assert_array_equal(tmet["cluster_counts"].numpy(), np.asarray(jmet["cluster_counts"]))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4,
                                   atol=1e-5 + floor.get("loss", 0.0), err_msg=f"round {r} loss")
        for k in ("dispersion", "reward_mean"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                       atol=1e-5 + floor["metrics"], err_msg=f"round {r} {k}")


@pytest.mark.parametrize("name", ["xlstm_1_3b", "zamba2_7b"])
def test_federated_steps_match_jax(models, name):
    """Three rounds of make_train_step (mode A): 4 clients x 2 sequences."""
    jm, tm, jp, _ = models[name]
    sc = dict(local_steps=2, client_lr=0.05, server_lr=0.05, d_sketch=32)
    toks = [_tokens(10 + r, (4, 2, S), jm.cfg.vocab) for r in range(3)]
    jres = _rounds(js.jit_train_step(js.make_train_step(jm, js.StepConfig(**sc))),
                   [jax.tree.map(jnp.copy, jp), js.yogi_init(jp), js.clustering_init(2, 32)],
                   [{"tokens": jnp.asarray(t)} for t in toks], _jax_snap)
    tp = params_from_numpy(_np(jp), "cpu")
    tres = _rounds(ts.make_train_step(tm, ts.StepConfig(**sc)),
                   [tp, ts.yogi_init(tp), ts.clustering_init(2, 32, device="cpu")],
                   [{"tokens": torch.from_numpy(t)} for t in toks], _port_snap)
    _held(tres, jres, FED_FLOORS[name])


@pytest.mark.parametrize("name", ["xlstm_1_3b", "zamba2_7b+tail"])
def test_central_steps_match_jax(models, name):
    """Two steps of make_central_train_step (mode B), 4 clients of 2."""
    jm, tm, jp, _ = models[name]
    sc = dict(server_lr=0.2, d_sketch=32)
    toks = [_tokens(20 + r, (8, S), jm.cfg.vocab) for r in range(2)]
    jres = _rounds(jax.jit(js.make_central_train_step(jm, js.StepConfig(**sc), n_clients=4)),
                   [jp, js.yogi_init(jp), js.clustering_init(2, 32)],
                   [{"tokens": jnp.asarray(t)} for t in toks], _jax_snap)
    tp = params_from_numpy(_np(jp), "cpu")
    tres = _rounds(ts.make_central_train_step(tm, ts.StepConfig(**sc), n_clients=4),
                   [tp, ts.yogi_init(tp), ts.clustering_init(2, 32, device="cpu")],
                   [{"tokens": torch.from_numpy(t)} for t in toks], _port_snap)
    _held(tres, jres, CENTRAL_FLOORS[name])


@pytest.mark.parametrize("arch", ["xlstm-1-3b", "zamba2-7b"])
def test_launch_train_on_the_cpu(capsys, arch):
    """The driver's width overrides (8 heads; hybrid: 8 SSM heads, a
    shared block every 2 layers; ssm: an sLSTM every 2) at d 16. The CLI
    ids are the configs' module names dashed (``xlstm-1-3b``), as in the
    JAX driver."""
    argv = ["--device", "cpu", "--arch", arch, "--rounds", "1", "--d-model", "16", "--layers", "4",
            "--vocab", "128", "--seq", "16", "--clients", "2"]
    params, opt, clust, metrics = ttrain.main(argv)
    out = capsys.readouterr().out
    assert arch in out and "round    0 loss" in out
    assert np.isfinite(float(metrics["loss"])) and float(metrics["cluster_counts"].sum()) == 2
    bb = params["backbone"]
    if arch.startswith("xlstm"):
        assert tuple(bb["mlstm"]["w_up"].shape) == (2, 1, 16, 64) and tuple(bb["slstm"]["r"].shape) == (2, 8, 4, 2, 2)
    else:
        assert tuple(bb["mamba"]["w_in"].shape) == (2, 2, 16, 2 * 32 + 2 * 64 + 8)
        assert tuple(bb["shared_attn"]["attn"]["wq"].shape) == (16, 8, 2)
    assert all(bool(torch.isfinite(a).all()) for a in leaves(params))
