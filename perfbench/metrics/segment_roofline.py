"""Share of its roofline of the segment-sum kernel (``kernels.ops.segment_aggregate``):
each call's byte bound (every input read once, the output written once, at
the HBM peak; the calls are bound by bytes) summed, over the summed event
times of the window's calls, in %."""
from perfbench.lib import peaks


def read(rec):
    calls = rec["spans"].get("segment", [])
    if not calls:
        return None
    bound_s = sum(nbytes for _, nbytes in calls) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(ms for ms, _ in calls) / 1e3)
