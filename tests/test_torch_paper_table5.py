"""Table 5 (``repro_torch.paper.table5_clustered_fl``) against the JAX
package's ``benchmarks/table5_clustered_fl.py`` at the cut of
tests/torch_paper_cases.py: the no-cohort baseline, Auxo and the
paper-faithful Auxo, IFCA, FL+HC and FlexCFL on femnist-like and
amazon-like, then CFL on its own population, in one process. The
reference's baselines train one client at a time and FL+HC and FlexCFL
link every client on the host in O(n^3), so this cut is smaller still:
100 clients and 30 participants a round (where Auxo still partitions on
both populations), and CFL's 100 clients (all of them every round) cut to
60."""
import repro.data
from torch_engine_cases import jax_compile_cache, one_torch_thread  # noqa: F401 (fixtures)
from torch_paper_cases import ROUNDS, assert_histories_match, assert_rows_match, cut

CFL_CLIENTS = 60


def test_table5(monkeypatch, jax_compile_cache):
    from benchmarks import table5_clustered_fl as J
    from repro_torch.paper import table5_clustered_fl as T

    runs = cut(monkeypatch, J, T, participants=30, clients=100)
    for mod in (repro.data, T):  # the reference imports make_population inside run()
        orig = mod.make_population
        monkeypatch.setattr(mod, "make_population", lambda _o=orig, **kw: _o(**{**kw, "n_clients": CFL_CLIENTS}))
    jrows = J.run(ROUNDS)
    trows = T.run(ROUNDS, device="cpu")
    algos = ["auxo", "auxo-paper-faithful", "ifca", "fl+hc", "flexcfl"]
    assert [(r["dataset"], r["algo"]) for r in trows] == (
        [("femnist-like", a) for a in algos] + [("amazon-like", a) for a in algos] + [("femnist-small", "cfl")]
    )
    assert_rows_match(jrows, trows)
    # per dataset: the baseline, Auxo, the paper-faithful Auxo (both partition)
    assert [k for k, _ in runs["port"]] == ["run_fl", "run_auxo", "run_auxo"] * 2
    assert_histories_match(runs["jax"], runs["port"])


def test_agglomerative_merges_as_the_reference():
    """FL+HC's and FlexCFL's linkage keeps its pair means across merges:
    the labels equal the reference's naive scan, ties included (repeated
    and rounded rows), and past the 250-point subsample."""
    import numpy as np

    from repro.fl.baselines import _agglomerative as ref
    from repro_torch.fl.baselines import _agglomerative as port

    rng = np.random.default_rng(0)
    for trial in range(24):
        n, d, k = int(rng.integers(3, 48)), int(rng.integers(2, 16)), int(rng.integers(1, 5))
        x = rng.normal(size=(n, d)).astype(np.float32)
        if trial % 3 == 0:
            x[n // 2:] = x[: n - n // 2]
        if trial % 4 == 0:
            x = np.round(x).astype(np.float32)
        np.testing.assert_array_equal(port(x, k), ref(x, k), err_msg=str(trial))
    x = rng.normal(size=(300, 8)).astype(np.float32)
    np.testing.assert_array_equal(port(x, 3, max_linkage=40), ref(x, 3, max_linkage=40))
