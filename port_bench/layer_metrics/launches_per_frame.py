"""Kernels launched in the window (the trace's kernel operations, copies and
fills left out) over the frames delivered in it."""


def read(run):
    if run.trace is None or not run.frames:
        return None
    return len(run.trace.kernels(run.trace.start, run.trace.deadline)) / run.frames
