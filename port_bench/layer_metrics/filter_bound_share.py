"""Filtered leaky ReLU: the least time of the window's filter calls, their
input read once and output written once at the card's HBM rate (the
program's counter ``ssar_tpu_torch.ops.filtered_lrelu.least_bytes``, reset
by the system at the end of set-up, over 3.35 TB/s), as a share of the
window's wall time (start to the end of its last track).  The same bytes
whatever implements the filter.  Nothing to read where no filter ran (or
where the program has no such counter)."""


def read(run):
    try:
        from ssar_tpu_torch.ops import filtered_lrelu
    except ImportError:
        return None
    moved = getattr(filtered_lrelu, "least_bytes", 0)
    if not getattr(filtered_lrelu, "calls", 0) or not moved or run.loop_s <= 0:
        return None
    return 100.0 * moved / run.peaks["hbm_bytes_per_s"] / run.loop_s
