"""Music information on the host: the seconds the window's tracks spent in tempo, beats and the Laplacian segmentations, as a share of the
window's wall time (start to the end of its last track)."""


def read(run):
    s = run.stage_s.get("segmentation")
    return None if s is None or run.loop_s <= 0 else 100.0 * s / run.loop_s
