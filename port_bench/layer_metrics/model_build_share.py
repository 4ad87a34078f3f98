"""Random-patch entry: the seconds the window's tracks spent in building the generator and its 180-latent palette (every call of generate), as a share of the
window's wall time (start to the end of its last track)."""


def read(run):
    s = run.stage_s.get("model_build")
    return None if s is None or run.loop_s <= 0 else 100.0 * s / run.loop_s
