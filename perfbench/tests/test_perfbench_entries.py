"""Each entry's reference against the program at a small configuration
on the CPU, through the whole run (set-up, window, the check), and the
check failing on each fault a cell can have: a step that returns its state
unchanged (the whole round's, and the clustering's alone), half of the
batch left out (the mean over the rest), a token altered where it is
produced. (The cells run on one chip: no exchange
between chips to leave out.) The look for a chip is skipped."""
import subprocess
import sys

import pytest

from perfbench import run as bench
from perfbench.lib import manifest

TRAIN = "granite-3-2b.fl_round.s512"
DECODE = "granite-3-2b.decode.l16"
SEED = 2**31 + 11
# the small configuration's own limits on the CPU (the cells' limits hold the
# card at full size): float32 at d 64, where the program's reductions run in
# other orders than the reference's (measured here: gaps up to ~2e-5 of a
# leaf's norm); every fault reads 1e-2 or more
SMALL_LIMITS = {TRAIN: {"loss_gap": 1e-5, "grad_gap": 3e-4, "change_gap": 3e-4, "sketch_gap": 1e-5,
                        "worst_grad_gap": 3e-4, "worst_change_gap": 3e-4, "cluster_mismatch": 0,
                        "cluster_gap": 1e-5},
                DECODE: {"token_gap": 1e-4, "logit_gap": 1e-5}}


def cell(workload, tiny, **kw):
    return bench.run(workload, SEED, 1.0, False, device="cpu", config=tiny, chips_check=False,
                     limits=SMALL_LIMITS[workload], **kw)


@pytest.mark.parametrize("workload", [TRAIN, DECODE])
def test_program_matches_reference(workload, tiny, one_thread):
    out = cell(workload, tiny)
    assert out["correct"], out
    assert set(out["checks"]) == set(manifest.limits(workload))
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"setup_s"} < set(out["metrics"])


@pytest.mark.parametrize("workload,fault", [(TRAIN, "unchanged"), (TRAIN, "half_batch"), (DECODE, "token")])
def test_fault_is_not_correct(workload, fault, tiny, one_thread):
    out = cell(workload, tiny, fault=fault)
    assert not out["correct"], out


def test_clustering_fault_shows_in_the_clustering_numbers(tiny, one_thread):
    """A clustering that keeps its state fails the clustering check and
    nothing else: its rewards, and so the round's update, are unchanged."""
    out = cell(TRAIN, tiny, fault="cluster_unchanged")
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failed and failed <= {"cluster_mismatch", "cluster_gap"}, out["checks"]


def test_traced_run_reports_per_layer_metrics(tiny, one_thread):
    out = bench.run(TRAIN, SEED, 1.0, True, device="cpu", config=tiny, chips_check=False,
                    limits=SMALL_LIMITS[TRAIN])
    assert out["correct"]
    names = {m["name"] for m in manifest.metrics_of(manifest.load(), TRAIN, True)}
    # on the CPU the profiler sees no device: the device's share is left out, the spans are read
    assert {"warmup_s", "local_train_ms", "sketch_ms", "segment_roofline", "mfu.train"} <= set(out["metrics"]) <= names
    assert "device_idle.train" not in out["metrics"]


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", TRAIN, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
