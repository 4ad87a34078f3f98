"""Render and synthesis: the host's seconds waiting on the card in the render
loop (the program's ``render.wait`` spans: each batch's
``done.synchronize()``), clipped to the traced window, as a share of it."""


def span_share(trace, name: str):
    """The program's ``span:<name>`` ranges clipped to the traced window,
    summed, in % of the window; None where none of them lies in it."""
    lo, hi = trace.start, trace.end
    parts = [min(e, hi) - max(s, lo) for n, s, e in trace.spans if n == name and min(e, hi) > max(s, lo)]
    return 100.0 * sum(parts) / (hi - lo) if parts else None


def read(run):
    return None if run.trace is None else span_share(run.trace, "render.wait")
