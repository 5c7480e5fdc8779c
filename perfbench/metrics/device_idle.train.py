"""Idle share of the device over whole traced steps of a training cell: 1
minus the union of the device's operation intervals over the traced span
(``torch.profiler``), in %."""


def read(rec):
    t = rec.get("trace") or {}
    if rec["kind"] != "train_tokens" or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
