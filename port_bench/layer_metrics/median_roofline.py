"""Kernel B1's share of its roofline: the least time of each launch in the
traced window (its line read once and its medians written once, over the
card's HBM rate; ``bytes.py``) over the device time of B1's launches on the
trace.  Nothing to read where the window launched no B1, or where the
trace's launches and the counted ones differ in number."""
from ..bytes import sliding_median_bytes


def read(run):
    numels = run.counters.get("sliding_median_numel")
    if run.trace is None or not numels:
        return None
    b1 = [e - s for name, s, e in run.trace.kernels() if "sliding_median" in name and "bwd" not in name]
    if len(b1) != len(numels) or sum(b1) <= 0:
        return None
    bound = sum(sliding_median_bytes(n) for n in numels) / run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / sum(b1)
