"""Median filters along one axis (HPSS's 31-tap windows).

Counterpart of ``ssar_tpu/ops/median.py``.  On a CUDA tensor the filter runs
the hand-written kernel (``median_cuda.py``, ``csrc/sliding_median.cu``) for
every odd width up to 31 along the last axis or the one before it; a build or
launch failure raises.  On a CPU tensor it runs the plain version below:
reflect pad, ``unfold`` into (..., k) windows, ``median``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def median_filter_plain(x: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """Reflect-padded sliding median of odd width `k` along `axis` (any device)."""
    p = k // 2
    xt = x.movedim(axis, -1)
    shape = xt.shape
    flat = F.pad(xt.reshape(-1, 1, shape[-1]), (p, p), mode="reflect")
    med = flat.unfold(-1, k, 1).median(dim=-1).values
    return med.reshape(shape).movedim(-1, axis)


def median_filter(x: torch.Tensor, k: int, axis: int = -1, mode: str = "reflect") -> torch.Tensor:
    """Sliding-window median of odd width `k` along `axis`, reflect padded
    (torch 'reflect': the edge sample is not repeated).  Exact."""
    if k % 2 != 1:
        raise ValueError("median_filter expects an odd window size")
    if mode != "reflect":
        raise ValueError(f"median_filter supports mode='reflect' only, got {mode!r}")
    axis = axis % x.ndim
    if x.is_cuda:
        from .median_cuda import sliding_median_cuda

        if axis >= x.ndim - 2:
            return sliding_median_cuda(x, k, axis)
        return sliding_median_cuda(x.movedim(axis, -1), k, -1).movedim(-1, axis)
    if x.device.type != "cpu":
        raise ValueError(f"median_filter runs on CUDA or CPU tensors, got {x.device}")
    return median_filter_plain(x, k, axis)

