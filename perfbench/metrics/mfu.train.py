"""The whole training step's share of the float32 peak: model FLOPs of the
window (``counts.train_flops``: 6 N T over the matmul parameters as
applied, plus causal attention, no recompute) over the window's seconds
times 67 TFLOP/s, in %."""
from perfbench.lib import counts, peaks


def read(rec):
    if rec["kind"] != "train_tokens" or not rec["steps"]:
        return None
    flops = counts.train_flops(rec["config"], rec["work"], rec["traffic"]["seq_len"])
    return 100.0 * flops / (rec["window_s"] * peaks.FP32_FLOPS)
