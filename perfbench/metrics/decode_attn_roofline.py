"""Share of its roofline of the decode-attention kernel: each call's least
bytes (q and the output once, K and V up to every lane's length:
``counts.attention_call_bytes``) at 3.35 TB/s, summed, over the summed
CUDA event times of the window's calls, in %."""
from perfbench.lib import counts, peaks


def read(rec):
    calls = rec["spans"].get("attention", [])
    if not calls:
        return None
    nbytes = sum(counts.attention_call_bytes(rec["config"], b, n) for _, (b, n) in calls)
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / (sum(ms for ms, _ in calls) / 1e3)
