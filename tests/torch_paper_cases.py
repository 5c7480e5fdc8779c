"""Shared cut and comparisons of the paper drivers' tests
(test_torch_paper_drivers.py, test_torch_paper_table5.py,
test_torch_paper_fig13.py, test_torch_paper_fig14.py): each driver's
``run()`` in the JAX package (``benchmarks/``) and in the port
(``repro_torch.paper``), shrunk alike on both sides with monkeypatch.

The cut: every scenario population at 150 clients, 40 participants a round
without availability traces (at 150 clients the traces leave too few
clients online a round to partition in 12 rounds, in both packages; the
traces are held in tests/test_torch_paper_options.py), and at most 12
rounds. At this size Auxo partitions on every scenario. Each run_fl /
run_auxo a driver makes is recorded, so whole histories are compared too.

The drivers run from each package's own seeded init, as a user runs
them: the port's truncated normals are a few ulp from the reference's
(torch's erfinv and XLA's), well inside the constants below at this cut.
"""
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CUT_CLIENTS = 150
CUT_FL = dict(participants_per_round=40, use_availability=False)
ROUNDS = 12

# Row floats derived from accuracies (means of per-client accuracies, each
# a group's accuracy over its 600 test points, or differences of two):
# params within the whole-run tolerance predict the same labels but at near
# ties, and one flipped prediction moves a group's accuracy by 1/600, so
# these are held within two flips, 2/600. acc_var / variance is 1e4 x the
# variance of accuracies in [0, 1]: moving each by at most ACC_TOL moves it
# by at most 1e4 x 2 x 0.5 x ACC_TOL. Ratios of simulated times and
# resources (speedup, resource_eff) are equal up to float rounding: the
# same round reaches the same target.
ACC_TOL = 2 / 600
VAR_TOL = 1e4 * ACC_TOL
ACC_KEYS = ("target_acc", "base_final", "auxo_final", "acc_improvement", "worst10", "best10",
            "auxo_worst10", "final_acc_gain", "ftfa_auxo")
VAR_KEYS = ("variance",)
RATIO_KEYS = ("speedup", "resource_eff")
DISCRETE_KEYS = ("dataset", "algo", "algorithm", "setting", "sweep", "value", "n_cohorts", "round")


def cut(monkeypatch, jmod, tmod, participants: int = CUT_FL["participants_per_round"],
        clients: int = CUT_CLIENTS):
    """Shrink one driver's scenarios alike in the JAX module ``jmod`` and
    the port's ``tmod`` (runs of more than ROUNDS rounds to ROUNDS);
    returns {package: [(kind, history), ...]}, every run_fl / run_auxo the
    drivers make, in call order."""
    import benchmarks.common as jcommon

    import repro_torch.paper.common as tcommon

    for common in (jcommon, tcommon):
        for name in common.SCENARIOS:
            monkeypatch.setitem(common.SCENARIOS, name, {**common.SCENARIOS[name], "n_clients": clients})
    runs = {"jax": [], "port": []}
    for pkg, mod, common in (("jax", jmod, jcommon), ("port", tmod, tcommon)):
        if hasattr(mod, "default_fl"):
            orig_fl = common.default_fl
            over = {**CUT_FL, "participants_per_round": participants}
            monkeypatch.setattr(mod, "default_fl", lambda rounds=100, seed=1, _o=orig_fl, _c=over, **kw: _o(
                min(rounds, ROUNDS), seed, **{**_c, **kw}))
        if hasattr(mod, "make_population"):  # fig13's affine-shift and table5's CFL populations
            orig_pop = mod.make_population
            monkeypatch.setattr(mod, "make_population", lambda _o=orig_pop, _n=clients, **kw: _o(
                **{**kw, "n_clients": min(kw.get("n_clients", _n), _n)}))
        for kind in ("run_fl", "run_auxo"):
            if hasattr(mod, kind):
                orig = getattr(mod, kind)

                def rec(*a, _o=orig, _k=kind, _l=runs[pkg], **kw):
                    out = _o(*a, **kw)
                    _l.append((_k, out[1] if _k == "run_auxo" else out))
                    return out

                monkeypatch.setattr(mod, kind, rec)
    return runs


def assert_rows_match(jrows, trows):
    """Same rows, same keys in the same order; discrete fields equal,
    floats within the constants above."""
    assert len(jrows) == len(trows)
    for a, b in zip(jrows, trows):
        assert list(a) == list(b)
        for k, v in a.items():
            w = b[k]
            if k in DISCRETE_KEYS or isinstance(v, str):
                assert v == w, (k, v, w)
            elif isinstance(v, float) and math.isnan(v):
                assert math.isnan(w), (k, w)
            elif k in ACC_KEYS:
                assert abs(v - w) <= ACC_TOL, (a, k, v, w)
            elif k in VAR_KEYS:
                assert abs(v - w) <= VAR_TOL, (a, k, v, w)
            elif k in RATIO_KEYS:
                assert v == pytest.approx(w, rel=1e-9, abs=0.0), (a, k, v, w)
            else:
                raise AssertionError(f"no rule for the field {k!r}")


def assert_histories_match(jruns, truns, partitions=lambda j: True):
    """Every recorded run's history row by row (discrete fields equal,
    accuracies within ACC_TOL, variances within VAR_TOL); the j-th Auxo run
    of the driver has partitioned where ``partitions(j)``."""
    assert [k for k, _ in jruns] == [k for k, _ in truns]
    j = 0
    for i, ((kind, jh), (_, th)) in enumerate(zip(jruns, truns)):
        assert len(jh) == len(th)
        for a, b in zip(jh, th):
            for k in ("round", "resource", "time", "n_cohorts"):
                assert a[k] == b[k], (i, kind, k, a[k], b[k])
            for k in ("acc_mean", "acc_worst10", "acc_best10"):
                assert abs(a[k] - b[k]) <= ACC_TOL, (i, kind, a["round"], k, a[k], b[k])
            assert abs(a["acc_var"] - b["acc_var"]) <= VAR_TOL, (i, kind, a["round"], a["acc_var"], b["acc_var"])
        if kind == "run_auxo":
            if partitions(j):
                assert th[-1]["n_cohorts"] >= 2, (i, [h["n_cohorts"] for h in th])
            j += 1
