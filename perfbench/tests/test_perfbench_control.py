"""The control on the card: the reference in TF32 in the program's place
is not correct under the cell's own limits, where the program is, at a
size a test run holds (granite's block at 4 layers, d 512, vocab 8192).
The cell-size readings that set the limits come from
``perfbench/control.py`` (PERF.md §4)."""
import pytest

from perfbench import control
from perfbench.lib import manifest

SMALL = {
    "name": "granite-small", "program_arch": "granite-3-2b",
    "program_sizes": {"n_layers": 4, "d_model": 512, "n_heads": 8, "n_kv_heads": 2, "d_ff": 2048, "vocab": 8192},
    "family": "dense", "hidden_size": 512, "intermediate_size": 2048, "num_hidden_layers": 4,
    "num_attention_heads": 8, "num_key_value_heads": 2, "vocab_size": 8192, "rms_norm_eps": 1e-05,
    "rope_theta": 10000.0, "tie_word_embeddings": True,
}


TRAIN, DECODE = "granite-3-2b.fl_round.s512", "granite-3-2b.decode.l16"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [TRAIN, DECODE])
def test_control_is_not_correct(workload, cuda):
    got = control.readings(workload, 2**31 + 5, ["program", "control"], device="cuda", config=SMALL)
    assert not control.judged(workload, got["control"])["correct"], got
    assert control.judged(workload, got["program"])["correct"], got


def test_judged_holds_every_number_to_its_limit():
    limits = manifest.limits(TRAIN)
    assert control.judged(TRAIN, dict(limits))["correct"]
    for name in limits:
        over = dict(limits, **{name: limits[name] * 2 + 1e-9})
        assert not control.judged(TRAIN, over)["correct"], name
        missing = {k: v for k, v in limits.items() if k != name}
        assert not control.judged(TRAIN, missing)["correct"], name
