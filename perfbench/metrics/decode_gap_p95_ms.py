"""95th percentile of the time between consecutive fleet steps in the
window (CUDA event marks at each step's first attention call; the gaps
across a call boundary hold the weight gather), over every gap."""
import numpy as np


def read(rec):
    gaps = [ms for ms, _ in rec["spans"].get("step", [])]
    return float(np.percentile(gaps, 95)) if gaps else None
