"""Render and synthesis: the seconds the window's tracks spent in the render loop (synthesis, I420 packing, the copy to the host, the writer; in the random-patch entry also its noise trees), as a share of the
window's wall time (start to the end of its last track)."""


def read(run):
    s = run.stage_s.get("render")
    return None if s is None or run.loop_s <= 0 else 100.0 * s / run.loop_s
