"""The port's four examples (``examples/port_*.py``) on the CPU, each held
against the JAX package's library calls with the same settings, in one
process (child clusterers are seeded from ``hash(child_id)``, which Python
randomizes per process):

- ``port_quickstart``: the baseline's and Auxo's accuracies at rtol 1e-4,
  atol 1e-5, the cohort counts and the cohorts' composition equal;
- ``port_robust_fl``: each scenario's final accuracy at the same
  tolerance, its cohort count and blacklist size equal; the failover and
  the soft-state rebuild restore the leaves;
- ``port_serve_cohorts``: both cohorts' greedy tokens equal over 4 steps;
- ``port_train_lm_federated``: the cluster counts equal over 2 rounds.

The runs are shortened with the examples' own flags (12 rounds or fewer).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import port_quickstart  # noqa: E402
import port_robust_fl  # noqa: E402
import port_serve_cohorts  # noqa: E402
import port_train_lm_federated  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
AUXO = dict(d_sketch=64, cluster_k=2, max_cohorts=2, clustering_start_frac=0.05, partition_start_frac=0.1,
            min_members=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _composition(eng, pop):
    groups = pop.client_groups()
    assign = np.array([eng.client_cohort(c) for c in range(pop.n_clients)])
    return {str(leaf): np.bincount(groups[assign == leaf], minlength=pop.n_groups).tolist()
            for leaf in sorted(set(assign))}


def test_quickstart_equals_the_reference(capsys):
    from repro.data import make_population
    from repro.fl import AuxoConfig, FLConfig, run_auxo, run_fl
    from repro.fl.task import MLPTask

    rounds, clients = 12, 120
    got = port_quickstart.main(["--device", "cpu", "--rounds", str(rounds), "--clients", str(clients)])
    out = capsys.readouterr().out
    assert "== Auxo ==" in out and "final accuracy: baseline" in out
    pop = make_population(n_clients=clients, n_groups=2, group_sep=0.0, dirichlet=2.0, label_conflict=0.6,
                          seed=0)
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    fl = FLConfig(rounds=rounds, participants_per_round=80, eval_every=10, seed=0, use_availability=False)
    base = run_fl(task, pop, fl)
    eng, hist = run_auxo(task, pop, fl, AuxoConfig(**AUXO))
    assert [h["round"] for h in got["base"]] == [h["round"] for h in base]
    _close([h["acc_mean"] for h in got["base"]], [h["acc_mean"] for h in base], "baseline")
    assert [h["n_cohorts"] for h in got["hist"]] == [h["n_cohorts"] for h in hist]
    _close([h["acc_mean"] for h in got["hist"]], [h["acc_mean"] for h in hist], "auxo")
    assert {str(k): v for k, v in got["composition"].items()} == _composition(eng, pop)
    assert hist[-1]["n_cohorts"] == 2


def test_robust_fl_equals_the_reference(capsys):
    from repro.core.coordinator import CohortCoordinator
    from repro.data import make_population
    from repro.fl import AuxoConfig, FLConfig, run_auxo
    from repro.fl.task import MLPTask

    rounds, clients = 12, 200
    got = port_robust_fl.main(["--device", "cpu", "--rounds", str(rounds), "--clients", str(clients)])
    out = capsys.readouterr().out
    assert "coordinator failover: tree restored with leaves" in out and "soft-state rebuild from" in out
    pop = make_population(n_clients=clients, n_groups=2, group_sep=0.0, label_conflict=0.5, seed=7)
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    for name, kw in port_robust_fl.SCENARIOS[:4]:  # "pre-failover" is "clean" again
        fl = FLConfig(rounds=rounds, participants_per_round=80, eval_every=39, use_availability=False, seed=7,
                      **kw)
        eng, hist = run_auxo(task, pop, fl, AuxoConfig(**AUXO))
        t_eng, t_hist = got["runs"][name]
        _close(t_hist[-1]["acc_mean"], hist[-1]["acc_mean"], name)
        assert t_hist[-1]["n_cohorts"] == hist[-1]["n_cohorts"], name
        assert len(t_eng.coordinator.blacklist) == len(eng.coordinator.blacklist), name
        assert t_eng.coordinator.tree.leaves() == eng.coordinator.tree.leaves(), name
    clean, again = got["runs"]["clean"][1], got["runs"]["pre-failover"][1]
    assert [h["acc_mean"] for h in clean] == [h["acc_mean"] for h in again]
    leaves = got["runs"]["pre-failover"][0].coordinator.tree.leaves()
    assert got["recovered"] == leaves and sorted(got["rebuilt"]) == sorted(leaves)
    co = CohortCoordinator(d_sketch=64)
    co.rebuild_from_requests(got["requests"])
    assert co.tree.leaves() == got["rebuilt"]


def test_serve_cohorts_tokens_equal_the_reference(capsys):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduce_config
    from repro.launch.steps import StepConfig, make_serve_step
    from repro.models import build_model

    got = port_serve_cohorts.main(["--device", "cpu", "--steps", "4"])
    assert capsys.readouterr().out.count("decoded 4 tokens for 8 requests") == 2
    cfg = reduce_config(get_config("qwen3-8b")).replace(d_model=256, vocab=1024)
    model = build_model(cfg)
    serve = jax.jit(make_serve_step(model, StepConfig()))
    key = jax.random.key(0)
    for i, cohort in enumerate(("0.0", "0.1")):
        params, cache = model.init(jax.random.fold_in(key, i)), model.init_cache(8, 128)
        tok = jax.random.randint(key, (8, 1), 0, cfg.vocab)
        want = []
        for _ in range(4):
            logits, cache = serve(params, cache, {"tokens": tok})
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            want.append(np.asarray(tok)[:, 0])
        np.testing.assert_array_equal(got[cohort], np.stack(want), err_msg=cohort)


def test_train_lm_federated_cluster_counts_equal_the_reference(capsys):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.steps import StepConfig, clustering_init, make_train_step, yogi_init
    from repro.models import build_model

    d, layers, seq, vocab, clients = 64, 2, 64, 256, 8
    got = port_train_lm_federated.main(["--device", "cpu", "--rounds", "2", "--d-model", str(d), "--layers",
                                        str(layers), "--seq", str(seq), "--vocab", str(vocab)])
    out = capsys.readouterr().out
    assert "latent groups: [4, 4]" in out and "round    1  loss" in out
    cfg = get_config("granite-3-2b").replace(n_layers=layers, d_model=d, n_heads=8, n_kv_heads=4, d_ff=4 * d,
                                             vocab=vocab, tie_embeddings=True, attn_qchunk=0, ce_chunk=128)
    model = build_model(cfg)
    sc = StepConfig(local_steps=2, client_lr=0.3, server_lr=0.3, clip_norm=10.0, d_sketch=128)
    step = jax.jit(make_train_step(model, sc))
    params = model.init(jax.random.key(0))
    opt, clust = yogi_init(params), clustering_init(sc.cluster_k, sc.d_sketch)
    toks, _ = port_train_lm_federated.synth_corpus(None, clients, 2, seq, vocab)
    counts, losses = [], []
    for _ in range(2):
        params, opt, clust, metrics = step(params, opt, clust, {"tokens": jnp.asarray(toks.numpy())})
        counts.append(np.asarray(metrics["cluster_counts"]).astype(int).tolist())
        losses.append(float(metrics["loss"]))
    assert [h["counts"] for h in got] == counts
    # the first round's loss (the clients' first local step, from weights
    # equal up to erfinv's last bits); later rounds carry XLA's float32
    # gradient error, ~2e-4 of a gradient's scale (tests/test_torch_lm_train.py)
    _close(got[0]["loss"], losses[0], "round 0 loss")
