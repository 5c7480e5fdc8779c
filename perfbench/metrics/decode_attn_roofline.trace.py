"""Share of its roofline of decode attention, timed on the device trace:
each ``decode.attention`` span's least bytes (q and the output once, K and
V up to every lane's length: ``counts.attention_call_bytes`` for each
cache row's lanes at the row's position, from the parent ``decode.step``
span's meta) at 3.35 TB/s, summed, over the device milliseconds of the
operations launched inside those spans, by the join of the profiler's
trace with the program's spans (``lib/program.py``), in %. Unlike CUDA
events on the stream, the operations' own times hold no wait for the host."""
from perfbench.lib import counts, peaks


def read(rec):
    prog = (rec.get("trace") or {}).get("program") or {}
    items = prog.get("items") or []
    steps = {s["id"]: s["meta"].get("positions") for s in items if s["name"] == "decode.step"}
    calls = [s for s in items if s["name"] == "decode.attention" and steps.get(s["parent"])]
    ms = sum(s["device_ms"] for s in calls)
    if not calls or ms <= 0:
        return None
    lanes = rec["lanes"]
    nbytes = sum(counts.attention_call_bytes(rec["config"], lanes, p + 1)
                 for s in calls for p in steps[s["parent"]])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / (ms / 1e3)
