"""Features: the seconds the window's tracks spent in the audio features on the card (the reactor's audio2features; the random-patch entry's eight music-information features), as a share of the
window's wall time (start to the end of its last track)."""


def read(run):
    s = run.stage_s.get("features")
    return None if s is None or run.loop_s <= 0 else 100.0 * s / run.loop_s
