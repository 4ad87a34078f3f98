"""The device's idle share: 1 - the union of its activity intervals over the
traced window (start to the end of its last track)."""


def read(run):
    if run.trace is None:
        return None
    span = run.trace.end - run.trace.start
    return 100.0 * (1.0 - run.trace.busy_s() / span) if span > 0 else None
