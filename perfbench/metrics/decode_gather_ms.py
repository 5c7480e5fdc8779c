"""Device milliseconds a decode call of the weight gather: the device
operations launched inside the program's ``decode.gather`` span (the live
rows' weights copied out of the bank) in the traced call, by the join of
the profiler's trace with the program's spans (``lib/program.py``)."""
from perfbench.lib import program


def read(rec):
    return program.per_root((rec.get("trace") or {}).get("program"), "decode.gather", "device_ms", "decode.call")
