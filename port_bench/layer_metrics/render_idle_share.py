"""Render and synthesis: the device's idle time while the host was in the
render loop (each of the program's ``render.loop`` spans, clipped to the
traced window, less the device's activity within it), as a share of the
window.  The rest of ``device_idle_share`` fell outside the render loop."""


def read(run):
    t = run.trace
    if t is None:
        return None
    loops = [(max(s, t.start), min(e, t.end)) for n, s, e in t.spans
             if n == "render.loop" and min(e, t.end) > max(s, t.start)]
    if not loops:
        return None
    return 100.0 * sum(hi - lo - t.busy_s(lo, hi) for lo, hi in loops) / (t.end - t.start)
