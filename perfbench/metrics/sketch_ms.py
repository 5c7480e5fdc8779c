"""Device milliseconds of the sketch (``GradientSketcher.batch``), CUDA
events around the call; mean over the window's steps."""
import statistics


def read(rec):
    ms = [t for t, _ in rec["spans"].get("sketch", [])]
    return statistics.fmean(ms) if ms else None
