"""The whole decode step's share of its roofline, which the HBM peak sets:
each fleet step's least bytes (every live row's weights once, every lane's
K/V up to its length: ``counts.decode_step_bytes``) at 3.35 TB/s, summed
over the window's steps, over the summed step gaps, in %."""
from perfbench.lib import counts, peaks


def read(rec):
    gaps = rec["spans"].get("step", [])
    if rec["kind"] != "decode_tokens" or not gaps:
        return None
    nbytes = sum(counts.decode_step_bytes(rec["config"], rec["rows"], rec["lanes"], n) for _, n in gaps)
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / (sum(ms for ms, _ in gaps) / 1e3)
