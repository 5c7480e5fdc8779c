"""Peak device memory over set-up and window (``torch.cuda.max_memory_allocated``,
read before the output check), in GB of 1e9 bytes."""


def read(rec):
    return rec["memory_peak_bytes"] / 1e9 if rec["memory_peak_bytes"] else None
