"""Figure 13 (``repro_torch.paper.fig13_sensitivity``) against the JAX
package's ``benchmarks/fig13_sensitivity.py`` at the cut of
tests/torch_paper_cases.py, every sweep value: the affine-shift
populations (baseline and Auxo), then Auxo under each partition window,
cohort cap and clustering start, in one process."""
from torch_engine_cases import jax_compile_cache, one_torch_thread  # noqa: F401 (fixtures)
from torch_paper_cases import ROUNDS, assert_histories_match, assert_rows_match, cut


def test_fig13(monkeypatch, jax_compile_cache):
    from benchmarks import fig13_sensitivity as J
    from repro_torch.paper import fig13_sensitivity as T

    runs = cut(monkeypatch, J, T)
    jrows = J.run(ROUNDS)
    trows = T.run(ROUNDS, device="cpu")
    assert [(r["sweep"], r["value"]) for r in trows] == (
        [("affine_shift", v) for v in T.AFFINE_SHIFTS] + [("partition_start", v) for v in T.PARTITION_STARTS]
        + [("max_cohorts", v) for v in T.MAX_COHORTS] + [("cluster_start", v) for v in T.CLUSTER_STARTS]
    )
    assert_rows_match(jrows, trows)

    # every Auxo run partitions but the one the sweep caps at one cohort
    capped = [i for i, r in enumerate(trows) if (r["sweep"], r["value"]) == ("max_cohorts", 1)]
    assert_histories_match(runs["jax"], runs["port"], lambda j: j not in capped)
