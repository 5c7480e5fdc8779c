"""Idle share of the device over a whole traced decode call: 1 minus the
union of the device's operation intervals over the traced span
(``torch.profiler``), in %."""


def read(rec):
    t = rec.get("trace") or {}
    if rec["kind"] != "decode_tokens" or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
