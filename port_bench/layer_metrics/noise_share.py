"""Noise trees: the host's seconds enqueuing the random-patch entry's lazy
noise trees, a chunk's at a time (the program's ``render.noise`` spans),
clipped to the traced window, as a share of it."""
from .render_wait_share import span_share


def read(run):
    return None if run.trace is None else span_share(run.trace, "render.noise")
