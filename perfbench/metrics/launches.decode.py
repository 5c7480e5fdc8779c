"""Device operations (kernels, copies, sets) launched a fleet step inside
the program's ``decode.step`` spans in the traced call, by the join of the
profiler's trace with the program's spans (``lib/program.py``)."""
from perfbench.lib import program


def read(rec):
    return program.per_root((rec.get("trace") or {}).get("program"), "decode.step", "launches", "decode.step")
