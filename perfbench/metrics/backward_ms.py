"""Device milliseconds a round of the model's backward passes: the device
operations launched inside the program's ``train.backward`` spans (the
gradients of each local step, the checkpointed layers' recompute
included) in the traced round, by the join of the profiler's trace with
the program's spans (``lib/program.py``). Autograd launches them from its
own thread; the join puts them under the span open on the program's."""
from perfbench.lib import program


def read(rec):
    return program.per_root((rec.get("trace") or {}).get("program"), "train.backward", "device_ms", "train.round")
