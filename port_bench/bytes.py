"""Bytes a kernel launch needs, counted from its shapes: each input byte read
once and each output byte written once."""
from __future__ import annotations


def sliding_median_bytes(numel: int, itemsize: int = 4) -> int:
    """Kernel B1 (``csrc/sliding_median.cu``): the line read and its medians
    written, float32 (the wrapper casts half types up before launching)."""
    return 2 * numel * itemsize
