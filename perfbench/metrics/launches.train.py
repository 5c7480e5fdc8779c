"""Device operations (kernels, copies, sets) launched a round inside the
program's ``train.round`` span in the traced round, by the join of the
profiler's trace with the program's spans (``lib/program.py``)."""
from perfbench.lib import program


def read(rec):
    return program.per_root((rec.get("trace") or {}).get("program"), "train.round", "launches", "train.round")
