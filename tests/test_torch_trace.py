"""The port's spans (``repro_torch.utils.trace``): off by default, nested
by thread, and placed where the round and the decoder do their work.

A federated round on a tiny granite and a cohort decode on the CPU, each
under ``recording()``: the spans come out where the program's layers are
(one ``train.round``, a forward and a backward span per local step, one
``sketch.draw`` per block drawn; one ``decode.call``, one gather, a step
per position and an attention span per layer under it), and the outputs
are bit-equal with recording on and off.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as rnd
from repro_torch.configs import get_config
from repro_torch.core import sketch
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.serve import CohortDecoder
from repro_torch.utils import trace
from repro_torch.utils.tree import leaves, tree_map

SIZES = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
D_SKETCH = 16
# leaves whose matrices exceed this many floats are drawn anew every round:
# the tiny model's weight matrices are, its norm scales are kept
CACHE_FLOATS = 1 << 15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_model(get_config("granite-3-2b").replace(**SIZES))


def _names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not trace.on()
    a, b = trace.span("x"), trace.span("y", meta=1)
    assert a is b is trace.OFF
    with trace.span("x") as s:
        assert s is trace.OFF
    with trace.recording() as kept:
        assert trace.on()
    assert kept == [] and not trace.on()
    with trace.span("after"):
        pass
    assert kept == []


def test_nesting_parents_roots_and_a_raising_body():
    with trace.recording() as kept:
        with trace.span("root", n=1) as r:
            with trace.span("child") as c:
                with trace.span("leaf"):
                    pass
            with pytest.raises(ValueError):
                with trace.span("raises"):
                    raise ValueError("closed all the same")
        with trace.span("second"):
            pass
    assert [s.name for s in kept] == ["leaf", "child", "raises", "root", "second"]
    by = {s.name: s for s in kept}
    assert r.parent is None and r.root == r.id and r.meta == {"n": 1}
    assert by["child"].parent == r.id and by["leaf"].parent == c.id
    assert by["raises"].parent == r.id and by["raises"].end >= by["raises"].start > 0
    assert {by[n].root for n in ("child", "leaf", "raises")} == {r.id}
    assert by["second"].root == by["second"].id != r.id and by["second"].parent is None
    assert r.start <= c.start <= by["leaf"].start <= by["leaf"].end <= c.end <= r.end
    with pytest.raises(RuntimeError):
        with trace.recording():
            with trace.recording():
                pass
    assert not trace.on()


def _round_inputs(model, seed):
    params = model.init(rnd.key(seed), device="cpu")
    opt = steps.yogi_init(params)
    sc = steps.StepConfig(local_steps=2, d_sketch=D_SKETCH)
    clust = steps.clustering_init(sc.cluster_k, sc.d_sketch, device="cpu")
    toks = np.random.default_rng(seed).integers(0, model.cfg.vocab, size=(3, 4, 16))
    return params, opt, clust, sc, {"tokens": torch.from_numpy(toks)}


def _blocks_drawn(model, params):
    """(every block of the sketch's leaves, the blocks of the leaves whose
    matrices are not kept across rounds)."""
    picked = sketch.GradientSketcher(d_sketch=D_SKETCH, strategy="last_block_proj")._selected(
        tree_map(lambda a: a[None], params))
    sizes = [l[0].numel() for _, l in picked]
    redrawn = [n for n in sizes if sketch.n_blocks(n) * sketch._block_size(n) * D_SKETCH > CACHE_FLOATS]
    assert redrawn and len(redrawn) < len(sizes)  # both kinds of leaf
    return sum(map(sketch.n_blocks, sizes)), sum(map(sketch.n_blocks, redrawn))


def _rounds(model, record: bool, n: int = 2):
    params, opt, clust, sc, batch = _round_inputs(model, 3)
    step = steps.make_train_step(model, sc)
    sketches, rounds = [], []
    update = steps.clustering_update

    def kept(state, x, ema=0.3):
        sketches.append(x.clone())
        return update(state, x, ema)

    steps.clustering_update = kept
    try:
        for _ in range(n):
            if record:
                with trace.recording() as spans:
                    params, opt, clust, _ = step(params, opt, clust, batch)
                rounds.append(spans)
            else:
                params, opt, clust, _ = step(params, opt, clust, batch)
    finally:
        steps.clustering_update = update
    return params, opt, sketches, rounds


def test_round_spans_and_bit_equal_outputs(model, monkeypatch):
    monkeypatch.setattr(sketch, "CACHE_FLOATS", CACHE_FLOATS)
    p_on, o_on, sk_on, rounds = _rounds(model, True)
    p_off, o_off, sk_off, _ = _rounds(model, False)
    for a, b in zip(leaves(p_on) + leaves(o_on) + sk_on, leaves(p_off) + leaves(o_off) + sk_off):
        assert torch.equal(a, b)

    every, redrawn = _blocks_drawn(model, p_on)
    C, local_steps = 3, 2
    for i, spans in enumerate(rounds):
        n = _names(spans)
        assert n["train.round"] == 1 and n["train.local"] == 1 and n["sketch"] == 1
        assert n["train.forward"] == n["train.backward"] == C * local_steps
        assert n.get("sketch.draw", 0) == (every if i == 0 else redrawn)
        assert n["sketch.project"] == every
        assert n["kernels.segment_aggregate"] > 0
        root = next(s for s in spans if s.name == "train.round")
        assert all(s.root == root.id for s in spans)
        by_id = {s.id: s for s in spans}
        for s in spans:
            if s.name in ("train.forward", "train.backward"):
                assert by_id[s.parent].name == "train.local"
            if s.name in ("sketch.draw", "sketch.project"):
                assert by_id[s.parent].name == "sketch"
        seg = next(s for s in spans if s.name == "kernels.segment_aggregate")
        assert set(seg.meta) == {"shape", "data_itemsize", "ids_itemsize", "weighted", "k"}
        assert len(seg.meta["shape"]) == 3


def _decoder(model):
    bank = model.init_bank(rnd.key(7), 3, device="cpu")
    live = [0, 2]
    dec = CohortDecoder(model, lambda: bank, lambda: list(live), lanes=2, page_size=16,
                        backend="ref", device="cpu")
    return dec


def test_decode_spans_and_bit_equal_tokens(model):
    n, L = 5, model.cfg.n_layers
    on, off = _decoder(model), _decoder(model)
    toks_off, logits_off = off.decode(3)
    toks_on, logits_on = on.decode(3)  # the same first call, not recorded
    with trace.recording() as spans:
        toks_on, logits_on = on.decode(n)
    toks_off, logits_off = off.decode(n)
    np.testing.assert_array_equal(toks_on, toks_off)
    np.testing.assert_array_equal(logits_on, logits_off)

    names = _names(spans)
    assert names == {"decode.call": 1, "decode.gather": 1, "decode.step": n, "decode.attention": n * L}
    call = next(s for s in spans if s.name == "decode.call")
    assert call.meta == {"rows": 2, "lanes": 2, "steps": n} and call.parent is None
    by_id = {s.id: s for s in spans}
    steps_ = sorted((s for s in spans if s.name == "decode.step"), key=lambda s: s.start)
    assert [s.meta["positions"] for s in steps_] == [[3 + i] * on.cache.rows for i in range(n)]
    for s in spans:
        assert s.root == call.id
        if s.name in ("decode.gather", "decode.step"):
            assert s.parent == call.id
        if s.name == "decode.attention":
            assert by_id[s.parent].name == "decode.step"
    for st in steps_:
        assert sum(s.parent == st.id for s in spans) == L
