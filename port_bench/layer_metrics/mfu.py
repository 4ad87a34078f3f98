"""The whole step's share of the card's bf16 peak: the operations of the
frames delivered in the window (``flops.py``) over the window's seconds."""


def read(run):
    if not run.frames or not run.flops_per_frame:
        return None
    return 100.0 * run.flops_per_frame * run.frames / run.seconds / run.peaks["bf16_flops_per_s"]
