"""Patch: the seconds the window's tracks spent in Patch.forward (latent sequences and the noise trees' banks), as a share of the
window's wall time (start to the end of its last track)."""


def read(run):
    s = run.stage_s.get("patch")
    return None if s is None or run.loop_s <= 0 else 100.0 * s / run.loop_s
