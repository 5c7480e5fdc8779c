"""Device milliseconds a round of the model's forward passes: the device
operations launched inside the program's ``train.forward`` spans (every
client's loss call, each local step) in the traced round, by the join of
the profiler's trace with the program's spans (``lib/program.py``)."""
from perfbench.lib import program


def read(rec):
    return program.per_root((rec.get("trace") or {}).get("program"), "train.forward", "device_ms", "train.round")
