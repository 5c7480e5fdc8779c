"""One synchronous Auxo round, and a whole run, in the port against the
JAX package, in one process (child clusterers are seeded from
``hash(child_id)``, which Python randomizes per process).

Float outputs agree within rtol 1e-4 / atol 1e-5: XLA and torch on the CPU
sum matrix products and reductions in different orders, so results differ
in the last bits and the run-to-run drift of a dozen FedYoGi rounds stays
around 1e-6. Discrete outcomes — partitions, leaf composition — must be
equal.
"""
import numpy as np
import pytest
import torch

from repro.data import make_population as jmake
from repro.fl import AuxoConfig as JAuxo, AuxoEngine as JEngine, FLConfig as JFL
from repro.fl.task import MLPTask as JTask
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_population as tmake
from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

RTOL, ATOL = 1e-4, 1e-5
# examples/quickstart.py, scaled from 600 clients / 50 rounds / 80
# participants to 120 / 12 / 40
POP = dict(n_clients=120, n_groups=2, group_sep=0.0, dirichlet=2.0, label_conflict=0.6, seed=0)
FL = dict(rounds=12, participants_per_round=40, eval_every=4, seed=0, use_availability=False)
AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=2, clustering_start_frac=0.05,
            partition_start_frac=0.1, min_members=8)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


@pytest.fixture(scope="module")
def engines():
    je = JEngine(JTask(dim=32, n_classes=10), jmake(**POP), JFL(**FL), JAuxo(**AUXO))
    jh = je.run()
    te = AuxoEngine(
        MLPTask(dim=32, n_classes=10), tmake(**POP), FLConfig(**FL), AuxoConfig(**AUXO),
        device="cpu", init_params=_np_tree(je._init_params),
    )
    th = te.run()
    return je, jh, te, th


def test_whole_slice_matches_jax(engines):
    je, jh, te, th = engines
    jp = [(e.parent, e.children, e.round_idx) for e in je.coordinator.partitions]
    tp = [(e.parent, e.children, e.round_idx) for e in te.coordinator.partitions]
    assert jp, "the scaled quickstart must partition"
    assert tp == jp
    assert te.coordinator.tree.leaves() == je.coordinator.tree.leaves()
    assert te.serving_cohorts() == je.serving_cohorts()  # leaf composition
    assert [h["n_cohorts"] for h in th] == [h["n_cohorts"] for h in jh]
    for a, b in zip(jh, th):
        assert abs(a["acc_mean"] - b["acc_mean"]) <= 1e-2
    jb, tb = je.pipeline.bank, te.pipeline.bank
    assert tb.slot_of == jb.slot_of
    for cid, slot in jb.slot_of.items():
        for k, v in jb.params.items():
            np.testing.assert_allclose(
                tb.params[k][slot].numpy(), np.asarray(v)[slot], rtol=RTOL, atol=ATOL,
                err_msg=f"{cid}/{k}",
            )


def test_stage2_fused_step_matches_jax(engines):
    """Given the JAX package's MatchPlan and packed rows, the port's fused
    step returns the same new bank, opt state, sketches and losses."""
    je, _, te, _ = engines
    r = FL["rounds"]
    plan = je.pipeline.plan_round(r)
    staged = je.pipeline._pack_rows(plan)
    assert len(plan.active) >= 2, "exercise several cohorts in one step"
    jbank_p, jbank_o = je.pipeline.bank.params, je.pipeline.bank.opt_state
    jp, jo, jsk, jl = je.pipeline._exec_step(jbank_p, jbank_o, *staged)

    tpipe = te.pipeline
    tpipe.bank.params = params_from_numpy(_np_tree(jbank_p), "cpu")
    tpipe.bank.opt_state = params_from_numpy(_np_tree(jbank_o), "cpu")
    slot_rows, xs, ys, seed, inv, sizes, kept, upd = (np.asarray(a) for a in staged)
    # on one device the JAX package's canonical row order is the identity
    np.testing.assert_array_equal(inv, np.arange(inv.size))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    with torch.no_grad():
        tp, to, tsk, tl = tpipe._exec_step(
            t(slot_rows).long(), t(xs), t(ys), int(seed), t(inv).long(), t(sizes), t(kept), t(upd)
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tsk.numpy(), np.asarray(jsk), rtol=RTOL, atol=ATOL)
    for k, v in jp.items():
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)
    for g in ("m", "v"):
        for k, v in jo[g].items():
            np.testing.assert_allclose(
                to[g][k].numpy(), np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=f"{g}/{k}"
            )
    # slots that did not train stay bit-identical
    for k in jp:
        frozen = ~np.asarray(upd)
        np.testing.assert_array_equal(tp[k].numpy()[frozen], np.asarray(jbank_p[k])[frozen])
