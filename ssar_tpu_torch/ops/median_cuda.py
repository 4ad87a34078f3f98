"""ctypes binding of the CUDA sliding-median kernel (csrc/sliding_median.cu).

Replaces the TPU kernel ``ssar_tpu/ops/median_pallas.py``
(``_median_kernel`` / ``sliding_median_lastaxis``).  The wrapper checks
device, dtype and shape, allocates the output, launches on PyTorch's current
stream and raises if the launch is refused.  ``launches`` counts the launches
made through it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_K = 31  # widths instantiated in the source: every odd k in [1, 31]

launches = 0


def _fn():
    lib = _build.load("sliding_median")
    fn = lib.ssar_sliding_median_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sliding_median_cuda(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Median of the odd k-wide window along ``axis`` (the last or the one
    before it) of a CUDA float32 tensor, torch-'reflect' padded.  Leading
    dimensions are a batch.  The axis before the last is filtered in place
    of its strides (no transpose copy)."""
    global launches
    if not x.is_cuda:
        raise ValueError("sliding_median_cuda takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"sliding_median_cuda takes float32, got {x.dtype}")
    if k % 2 != 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"window width must be odd and at most {MAX_K}, got {k}")
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"sliding_median_cuda takes a non-empty tensor, got shape {tuple(x.shape)}")
    axis = axis % x.ndim
    if axis < x.ndim - 2:
        raise ValueError("sliding_median_cuda filters the last axis or the one before it")
    L = x.shape[axis]
    if k // 2 >= L:
        raise ValueError(f"reflect padding by {k // 2} needs more than {k // 2} elements along the axis, got {L}")

    x = x.contiguous()
    v = x.reshape(-1, *x.shape[-2:]) if x.ndim >= 2 else x.reshape(1, 1, -1)
    nb, R, T = v.shape
    if axis == x.ndim - 1:  # lines along the last axis: one per (batch, row)
        n_rows, rows_per_batch, batch_stride, row_stride, pos_stride = nb * R, R, R * T, T, 1
    else:                   # lines along the axis before it: one per (batch, column)
        n_rows, rows_per_batch, batch_stride, row_stride, pos_stride = nb * T, T, R * T, 1, T
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), y.data_ptr(), k, n_rows, L, rows_per_batch, batch_stride,
                    row_stride, pos_stride, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sliding_median kernel launch failed: cudaError {err}")
    launches += 1
    return y
