"""The port's clustered-FL baselines (repro_torch.fl.baselines) against the
JAX package's (repro.fl.baselines), in one process, on
tests/test_baselines.py's scenario: 120 clients, 2 groups, label_conflict
0.6, seed 5; 12 rounds of 40 participants (CFL: 6 rounds, full
participation).

Both packages start from the JAX package's initial weights. The simulated
clock, resource and comm counters are host numpy sums of the same draws,
so every history record's round, time, resource and comm are EQUAL, and so
are the final assignments (IFCA's argmin over k losses and the
agglomerative merges are discrete). Accuracies agree to 1e-6 and the final
models within tests/test_torch_round.py's rtol 1e-4 / atol 1e-5: the port
trains a round's clients as the rows of one batched call where the JAX
package trains them one by one, so sums run in other orders.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import make_population as jmake
from repro.fl import FLConfig as JFL
from repro.fl import baselines as jb
from repro.fl.task import MLPTask as JTask
from repro_torch.data import make_population as tmake
from repro_torch.fl import FLConfig, MLPTask
from repro_torch.fl import baselines as tb

from torch_engine_cases import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
ACC_TOL = 1e-6
POP = dict(n_clients=120, n_groups=2, group_sep=0.0, label_conflict=0.6, seed=5)
FL = dict(rounds=12, participants_per_round=40, eval_every=4, seed=5)
CFL_FL = dict(rounds=6, participants_per_round=40, eval_every=2, seed=5)
K = 2
ALGOS = ("ifca", "flhc", "flexcfl", "cfl")


def _make(pkg, algo, task, pop, **kw):
    fl = (JFL if pkg is jb else FLConfig)(**(CFL_FL if algo == "cfl" else FL))
    cls = {"ifca": pkg.IFCA, "flhc": pkg.FLHC, "flexcfl": pkg.FlexCFL, "cfl": pkg.CFL}[algo]
    extra = dict(warmup_rounds=4) if algo == "flhc" else {}
    return cls(task, pop, fl, K, **extra, **kw)


def _run(algo_obj):
    """Run, capturing the last evaluation's (assignment, models): the
    final round is always evaluated, so these are the final ones."""
    seen = {}
    orig = algo_obj._eval

    def hook(r, assignment, models):
        seen["assignment"] = np.array(assignment)
        seen["models"] = [{k: np.asarray(v) for k, v in m.items()} for m in models]
        return orig(r, assignment, models)

    algo_obj._eval = hook
    hist = algo_obj.run()
    return hist, seen


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of each baseline, made once for the module."""
    cache = {}

    def get(algo):
        if algo not in cache:
            jpop, tpop = jmake(**POP), tmake(**POP)
            jtask = JTask(dim=jpop.dim, n_classes=jpop.n_classes)
            key = jax.random.key(FL["seed"])
            if algo == "ifca":
                init = [{k: np.asarray(v) for k, v in jtask.init(jax.random.fold_in(key, i)).items()}
                        for i in range(K)]
            else:
                init = {k: np.asarray(v) for k, v in jtask.init(key).items()}
            jh, jseen = _run(_make(jb, algo, jtask, jpop))
            talgo = _make(tb, algo, MLPTask(dim=tpop.dim, n_classes=tpop.n_classes), tpop,
                          device="cpu", init_params=init)
            th, tseen = _run(talgo)
            cache[algo] = (jh, jseen, th, tseen, talgo)
        return cache[algo]

    return get


@pytest.mark.parametrize("algo", ALGOS)
def test_histories_count_the_same_costs(runs, algo):
    jh, _, th, _, _ = runs(algo)
    assert len(th) == len(jh)
    for a, b in zip(jh, th):
        for key in ("round", "time", "resource", "comm"):
            assert b[key] == a[key], (key, a, b)


@pytest.mark.parametrize("algo", ALGOS)
def test_final_assignments_equal(runs, algo):
    _, jseen, _, tseen, _ = runs(algo)
    ja, ta = jseen["assignment"], tseen["assignment"]
    diff = np.flatnonzero(ja != ta)
    assert diff.size == 0, f"{algo}: clients {diff.tolist()} assigned {ja[diff]} vs {ta[diff]}"
    assert len(tseen["models"]) == len(jseen["models"])
    members = lambda a: sorted(tuple(np.flatnonzero(a == c)) for c in np.unique(a))  # noqa: E731
    assert members(ta) == members(ja)


@pytest.mark.parametrize("algo", ALGOS)
def test_accuracies_match(runs, algo):
    jh, _, th, _, _ = runs(algo)
    for a, b in zip(jh, th):
        for key in ("acc_mean", "acc_worst10", "acc_best10"):
            assert abs(a[key] - b[key]) <= ACC_TOL, (algo, a["round"], key, a[key], b[key])
        assert abs(a["acc_var"] - b["acc_var"]) <= ACC_TOL * 1e4, (algo, a["round"])


@pytest.mark.parametrize("algo", ALGOS)
def test_final_models_match(runs, algo):
    _, jseen, _, tseen, _ = runs(algo)
    for i, (jm, tm) in enumerate(zip(jseen["models"], tseen["models"])):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, atol=ATOL, err_msg=f"{algo} model {i} {k}")


def test_ifca_pays_broadcast_cost(runs):
    _, _, th, _, _ = runs("ifca")
    assert np.isfinite(th[-1]["acc_mean"])
    # k models broadcast every round: comm = k × participants × rounds
    assert th[-1]["comm"] == pytest.approx(K * FL["participants_per_round"] * FL["rounds"])


@pytest.mark.parametrize("algo", ["flhc", "flexcfl"])
def test_hierarchical_full_pass_cost(runs, algo):
    _, _, th, tseen, talgo = runs(algo)
    assert np.isfinite(th[-1]["acc_mean"])
    fl = talgo.fl
    # resource includes the one-shot FULL population pass
    per_round = fl.participants_per_round * fl.local_steps * fl.batch_size
    full_pass = POP["n_clients"] * fl.local_steps * fl.batch_size
    assert th[-1]["resource"] == fl.rounds * per_round + full_pass
    # the full pass's agglomerative merge split the population into the k groups
    assert sorted(np.unique(tseen["assignment"])) == list(range(K))


def test_cfl_full_participation(runs):
    _, _, th, _, talgo = runs("cfl")
    assert np.isfinite(th[-1]["acc_mean"])
    fl = talgo.fl
    # full participation: resource per round is the whole population
    assert th[-1]["resource"] == POP["n_clients"] * fl.local_steps * fl.batch_size * fl.rounds


@pytest.mark.parametrize("n,k,max_linkage", [(30, 2, 250), (45, 3, 250), (60, 2, 40), (60, 3, 40)])
def test_agglomerative_bit_equal(n, k, max_linkage):
    """The direct linkage and the subsample path (n > max_linkage) give
    bit-equal labels on identical inputs."""
    rng = np.random.default_rng(n + k)
    centers = rng.standard_normal((k, 16))
    x = (centers[rng.integers(0, k, n)] + 0.8 * rng.standard_normal((n, 16))).astype(np.float32)
    want = jb._agglomerative(x, k, max_linkage)
    got = tb._agglomerative(x, k, max_linkage)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == k


def test_flat_order_is_jax_leaf_order():
    """The first 256 columns FL+HC and CFL cluster on: biases, then the
    start of w0, in jax.tree.leaves order."""
    rng = np.random.default_rng(0)
    shapes = {"w0": (3, 4), "b0": (4,), "w1": (4, 2), "b1": (2,)}
    d = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    want = jb._np_flat({k: jax.numpy.asarray(v) for k, v in d.items()})
    np.testing.assert_array_equal(tb._np_flat({k: torch.from_numpy(v) for k, v in d.items()}), want)
    rows = {k: torch.from_numpy(np.stack([v, 2 * v])) for k, v in d.items()}
    np.testing.assert_array_equal(tb._rows_flat(rows), np.stack([want, 2 * want]))
    np.testing.assert_array_equal(tb._rows_flat(rows, 5), np.stack([want[:5], 2 * want[:5]]))
