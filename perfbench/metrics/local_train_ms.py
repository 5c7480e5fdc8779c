"""Device milliseconds of a step's local training: from the step's start to
the start of its server half (``GradientSketcher.batch`` in the federated
round), CUDA events; mean over the window's steps."""
import statistics


def read(rec):
    ms = [t for t, _ in rec["spans"].get("local_train", [])]
    return statistics.fmean(ms) if ms else None
