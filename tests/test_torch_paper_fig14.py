"""Figure 14 (``repro_torch.paper.fig14_resilience``) against the JAX
package's ``benchmarks/fig14_resilience.py`` at the cut of
tests/torch_paper_cases.py, every sweep value: local DP's sigma, the
label-poisoned share and the affinity-record loss rate, baseline and Auxo
each, in one process."""
from torch_engine_cases import jax_compile_cache, one_torch_thread  # noqa: F401 (fixtures)
from torch_paper_cases import ROUNDS, assert_histories_match, assert_rows_match, cut


def test_fig14(monkeypatch, jax_compile_cache):
    from benchmarks import fig14_resilience as J
    from repro_torch.paper import fig14_resilience as T

    runs = cut(monkeypatch, J, T)
    jrows = J.run(ROUNDS)
    trows = T.run(ROUNDS, device="cpu")
    assert [(r["sweep"], r["value"]) for r in trows] == (
        [("ldp_sigma", v) for v in T.LDP_SIGMAS] + [("corrupt_frac", v) for v in T.CORRUPT_FRACS]
        + [("affinity_loss", v) for v in T.AFFINITY_LOSS_RATES]
    )
    assert_rows_match(jrows, trows)
    # DP noise of sigma >= 0.6 on every element drowns the head sketches:
    # those Auxo runs do not partition in 12 rounds (in either package)
    noisy = [i for i, r in enumerate(trows) if r["sweep"] == "ldp_sigma" and r["value"] >= 0.6]
    assert_histories_match(runs["jax"], runs["port"], lambda j: j not in noisy)
