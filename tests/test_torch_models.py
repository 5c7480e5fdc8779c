"""The port's dense transformer (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, in one process.

Weights drawn from the same seed agree within a few float32 ulp (the two
packages' erfinv differ in the last bits). Blocks fed the same weights and
inputs agree within 1e-5: XLA and torch on the CPU sum matrix products in
different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import build_model as jbuild
from repro.models import common as jc
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch import random as rnd
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tc
from repro_torch.models import transformer as tt
from repro_torch.utils.tree import tree_map

DENSE = ["granite-3-2b", "h2o-danube-3-4b", "starcoder2-15b", "qwen3-8b"]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fields_equal(jcfg, tcfg):
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            assert (jnp.dtype(a).name, b) == ("float32", torch.float32), (jcfg.arch_id, a, b)
        else:
            assert a == b, (jcfg.arch_id, f.name, a, b)
    assert [f.name for f in dataclasses.fields(jcfg)] == [f.name for f in dataclasses.fields(tcfg)]


def test_registry_and_shapes_match_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.DASHED == jconfigs.DASHED
    assert tshapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name in jshapes.SHAPES:
        assert dataclasses.asdict(tshapes.SHAPES[name]) == dataclasses.asdict(jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_and_its_reduction_match_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch.replace("_", "-"))
    _fields_equal(jcfg, tcfg)
    _fields_equal(jconfigs.reduce_config(jcfg), tconfigs.reduce_config(tcfg))
    assert tconfigs.all_configs()[arch] == tcfg


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_jax(arch):
    jm, tm = jbuild(jconfigs.get_config(arch)), tbuild(tconfigs.get_config(arch))
    assert tm.param_count() == jm.param_count()
    assert all(a.device.type == "meta" for a in _flat(tm.init_shapes()).values())


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_init_shapes_takes_a_key(arch):
    """``init_shapes(key)``, as the reference's: the key changes no shape;
    the result stays on the meta device."""
    jm, tm = jbuild(jconfigs.reduce_config(jconfigs.get_config(arch))), tbuild(
        tconfigs.reduce_config(tconfigs.get_config(arch)))
    want = _flat(jm.init_shapes(jax.random.key(7)))
    for key in (None, rnd.key(7), rnd.key(7, device="meta")):
        got = _flat(tm.init_shapes(key))
        assert got.keys() == want.keys()
        for k, a in got.items():
            assert a.device.type == "meta" and tuple(a.shape) == want[k].shape, k


@pytest.mark.parametrize("arch", DENSE)
def test_model_init_matches_jax(arch):
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch)).replace(vocab=96, vocab_pad=128)
    tcfg = tconfigs.reduce_config(tconfigs.get_config(arch)).replace(vocab=96, vocab_pad=128)
    want = _flat(_np(jbuild(jcfg).init(jax.random.key(11))))
    got = _flat(tbuild(tcfg).init(rnd.key(11), device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
    # a bank filled in place slot by slot: slot i is init(fold_in(key, i))
    bank = _flat(tbuild(tcfg).init_bank(rnd.key(11), 3, device="cpu"))
    slot2 = _flat(tbuild(tcfg).init(rnd.fold_in(rnd.key(11), 2), device="cpu"))
    assert all(torch.equal(bank[k][2], slot2[k]) for k in slot2)


@pytest.fixture(scope="module")
def carried():
    """JAX params of a reduced qwen3-8b (qk_norm, θ = 1e6) and a reduced
    starcoder2 (GELU MLP, untied head), carried across to the port."""
    out = {}
    for arch, kw in (("qwen3-8b", {}), ("starcoder2-15b", dict(vocab=100, vocab_pad=128))):
        jcfg = jconfigs.reduce_config(jconfigs.get_config(arch)).replace(**kw)
        tcfg = tconfigs.reduce_config(tconfigs.get_config(arch)).replace(**kw)
        jp = jbuild(jcfg).init(jax.random.key(3))
        out[arch] = (jcfg, tcfg, jp, params_from_numpy(_np(jp), "cpu"))
    return out


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-15b"])
def test_blocks_match_jax(carried, arch):
    jcfg, tcfg, jp, tp = carried[arch]
    rng = np.random.default_rng(1)
    B, S = 2, 5
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    blk_j = jax.tree.map(lambda a: a[1], jp["backbone"]["blocks"])  # layer 1
    blk_t = tree_map(lambda a: a[1], tp["backbone"]["blocks"])
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(tc.rmsnorm(blk_t["attn_norm"], xt), jc.rmsnorm(blk_j["attn_norm"], xj))
    pos = rng.integers(0, 50, (B, S)).astype(np.int32)
    q = rng.standard_normal((B, S, 4, jcfg.hd)).astype(np.float32)
    _close(tc.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), tcfg.rope_theta),
           jc.apply_rope(jnp.asarray(q), jnp.asarray(pos), jcfg.rope_theta))
    for got, want in zip(tc._qkv(blk_t["attn"], tcfg, xt, torch.from_numpy(pos)),
                         jc._qkv(blk_j["attn"], jcfg, xj, jnp.asarray(pos))):
        _close(got, want)
    assert ("q_norm" in blk_t["attn"]) == tcfg.qk_norm
    _close(tc.mlp(blk_t["mlp"], xt), jc.mlp(blk_j["mlp"], xj))
    assert ("wg" in blk_t["mlp"]) == tcfg.gated_mlp
    tok = rng.integers(0, jcfg.vocab, (B, S))
    _close(tt.embed_tokens(tp, tcfg, torch.from_numpy(tok)), jt.embed_tokens(jp, jcfg, jnp.asarray(tok)))
    got = tt.lm_logits(tp, tcfg, xt)
    _close(got, jt.lm_logits(jp, jcfg, xj))
    assert got.shape[-1] == tcfg.padded_vocab
    if tcfg.padded_vocab > tcfg.vocab:  # pad slots masked
        assert float(got[..., tcfg.vocab:].max()) < -1e29


def test_qkv_without_qk_norm_and_tied_head_match_jax():
    jcfg = jconfigs.reduce_config(jconfigs.get_config("granite-3-2b"))
    tcfg = tconfigs.reduce_config(tconfigs.get_config("granite-3-2b"))
    assert tcfg.tie_embeddings and not tcfg.qk_norm
    jp = jbuild(jcfg).init(jax.random.key(4))
    tp = params_from_numpy(_np(jp), "cpu")
    assert "head" not in tp
    x = np.random.default_rng(2).standard_normal((3, 4, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(4, dtype=np.int32) + 7, (3, 1))
    blk_j = jax.tree.map(lambda a: a[0], jp["backbone"]["blocks"])
    blk_t = tree_map(lambda a: a[0], tp["backbone"]["blocks"])
    for got, want in zip(tc._qkv(blk_t["attn"], tcfg, torch.from_numpy(x), torch.from_numpy(pos)),
                         jc._qkv(blk_j["attn"], jcfg, jnp.asarray(x), jnp.asarray(pos))):
        _close(got, want)
    _close(tt.lm_logits(tp, tcfg, torch.from_numpy(x)), jt.lm_logits(jp, jcfg, jnp.asarray(x)))


def test_stacked_rows_match_per_row(carried):
    """With a leading row axis on params and inputs, each row uses its own
    weights (one bmm) and equals the unstacked call on that row."""
    jcfg, tcfg, jp, tp = carried["qwen3-8b"]
    bank = tbuild(tcfg).init_bank(rnd.key(5), 2, device="cpu")
    blk = tree_map(lambda a: a[:, 0], bank["backbone"]["blocks"])  # (2, ...) layer 0
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 1, tcfg.d_model, generator=g)
    pos = torch.tensor([[4], [9], [0]])[None].expand(2, 3, 1)
    q, k, v = tc._qkv(blk["attn"], tcfg, x, pos)
    m = tc.mlp(blk["mlp"], tc.rmsnorm(blk["mlp_norm"], x))
    logits = tt.lm_logits(bank, tcfg, x)
    emb = tt.embed_tokens(bank, tcfg, torch.tensor([[1, 2], [3, 4]]))
    for r in range(2):
        row = tree_map(lambda a: a[r], blk)
        for got, want in zip((q, k, v), tc._qkv(row["attn"], tcfg, x[r], pos[r])):
            torch.testing.assert_close(got[r], want, rtol=TOL, atol=TOL)
        torch.testing.assert_close(m[r], tc.mlp(row["mlp"], tc.rmsnorm(row["mlp_norm"], x[r])),
                                   rtol=TOL, atol=TOL)
        prow = tree_map(lambda a: a[r], bank)
        torch.testing.assert_close(logits[r], tt.lm_logits(prow, tcfg, x[r]), rtol=TOL, atol=TOL)
        torch.testing.assert_close(emb[r], prow["embed"][torch.tensor([[1, 2], [3, 4]])[r]])
