"""Device milliseconds a round of the sketch's draws: the device operations
launched inside the program's ``sketch.draw`` spans (each block's threefry
Rademacher matrix) in the traced round, by the join of the profiler's
trace with the program's spans (``lib/program.py``)."""
from perfbench.lib import program


def read(rec):
    return program.per_root((rec.get("trace") or {}).get("program"), "sketch.draw", "device_ms", "train.round")
