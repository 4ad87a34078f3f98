"""ctypes bindings of the CUDA sliding-median kernels (csrc/sliding_median.cu,
csrc/sliding_median_bwd.cu).

Replace the TPU kernel ``ssar_tpu/ops/median_pallas.py``
(``_median_kernel`` / ``sliding_median_lastaxis``) and its VJP
(``_sliding_median_bwd``).  Each wrapper checks device, dtype and shape,
allocates the output, launches on PyTorch's current stream and raises if the
launch is refused.  ``launches`` and ``bwd_launches`` count the launches made
through them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MAX_K = 31  # widths instantiated in the source: every odd k in [1, 31]

launches = 0
bwd_launches = 0


def _fn():
    lib = _build.load("sliding_median")
    fn = lib.ssar_sliding_median_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    lib = _build.load("sliding_median_bwd")
    fn = lib.ssar_sliding_median_bwd_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _line_layout(x: torch.Tensor, k: int, axis: int, who: str):
    """Checks shared by both kernels; returns (n_rows, L, rows_per_batch,
    batch_stride, row_stride, pos_stride) of the contiguous tensor's lines
    along ``axis`` (the last axis or the one before it)."""
    if not x.is_cuda:
        raise ValueError(f"{who} takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{who} takes float32, got {x.dtype}")
    if k % 2 != 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"window width must be odd and at most {MAX_K}, got {k}")
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"{who} takes a non-empty tensor, got shape {tuple(x.shape)}")
    axis = axis % x.ndim
    if axis < x.ndim - 2:
        raise ValueError(f"{who} filters the last axis or the one before it")
    L = x.shape[axis]
    if k // 2 >= L:
        raise ValueError(f"reflect padding by {k // 2} needs more than {k // 2} elements along the axis, got {L}")
    nb, R, T = (math.prod(x.shape[:-2]), *x.shape[-2:]) if x.ndim >= 2 else (1, 1, x.shape[0])
    if axis == x.ndim - 1:  # lines along the last axis: one per (batch, row)
        return nb * R, L, R, R * T, T, 1
    return nb * T, L, T, R * T, 1, T  # lines along the axis before it: one per (batch, column)


def sliding_median_cuda(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Median of the odd k-wide window along ``axis`` (the last or the one
    before it) of a CUDA float32 tensor, torch-'reflect' padded.  Leading
    dimensions are a batch.  The axis before the last is filtered in place
    of its strides (no transpose copy)."""
    global launches
    layout = _line_layout(x, k, axis, "sliding_median_cuda")
    x = x.contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), y.data_ptr(), k, *layout, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sliding_median kernel launch failed: cudaError {err}")
    launches += 1
    return y


def sliding_median_bwd_cuda(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Gradient of ``sliding_median_cuda(x, k, axis)`` for the output
    cotangent ``g``: each ``g[t]`` goes to the first window tap equal to
    ``out[t]``, the reflect halo folded back.  ``out`` is the forward's result."""
    global bwd_launches
    layout = _line_layout(x, k, axis, "sliding_median_bwd_cuda")
    for name, t in (("out", out), ("g", g)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"sliding_median_bwd_cuda: {name} {tuple(t.shape)} {t.dtype} {t.device} does not "
                             f"match x {tuple(x.shape)} {x.dtype} {x.device}")
    x, out, g = x.contiguous(), out.contiguous(), g.contiguous()
    gx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _bwd_fn()(x.data_ptr(), out.data_ptr(), g.data_ptr(), gx.data_ptr(), k, *layout,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sliding_median_bwd kernel launch failed: cudaError {err}")
    bwd_launches += 1
    return gx
