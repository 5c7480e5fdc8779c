"""The host's issue time of one fleet step as the profiler leaves it: the
median host milliseconds of the program's ``decode.step`` spans (every
layer's launches through the argmax and the position update) in the traced
call, by the program's clock. The call runs under the profiler, whose
device tracing adds its own cost to every launch, so the reading is higher
than an unprofiled step's, by more the more launches a step makes."""


def read(rec):
    spans = ((rec.get("trace") or {}).get("program") or {}).get("spans") or {}
    return spans["decode.step"]["host_ms_median"] if spans.get("decode.step", {}).get("count") else None
