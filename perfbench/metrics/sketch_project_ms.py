"""Device milliseconds a round of the sketch's products: the device
operations launched inside the program's ``sketch.project`` spans (each
block's rows times its matrix, summed) in the traced round, by the join of
the profiler's trace with the program's spans (``lib/program.py``)."""
from perfbench.lib import program


def read(rec):
    return program.per_root((rec.get("trace") or {}).get("program"), "sketch.project", "device_ms", "train.round")
