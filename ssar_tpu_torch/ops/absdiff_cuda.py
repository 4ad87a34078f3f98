"""ctypes binding of the CUDA absdiff kernel (csrc/absdiff.cu).

Replaces the TPU kernel ``ssar_tpu/ops/absdiff.py`` (``_absdiff_kernel`` /
``absdiff_pallas``).  The wrapper checks device, dtype and shape, allocates
the output, launches once for the whole batch on PyTorch's current stream
(``_build.launch``) and raises if the launch is refused.  The kernel computes
in float32: another floating dtype is cast to float32 for the launch and the
result back to the input's dtype, as ``absdiff_pallas`` does.  ``launches``
counts the launches made through it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_fn = None


def _resolve():
    """Build (at first use) and bind the entry point."""
    global _fn
    fn = _build.load("absdiff").ssar_absdiff_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn


def batch_absdiff_cuda(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) floating on the card -> (B, T) of its dtype: per batch row,
    the summed |x[t+1] - x[t]| over all trailing elements, with y[T-1] =
    y[T-2], accumulated in float32."""
    global launches
    if not x.is_cuda:
        raise ValueError("batch_absdiff_cuda takes a CUDA tensor")
    if not x.is_floating_point():
        raise TypeError(f"batch_absdiff_cuda takes a floating tensor, got {x.dtype}")
    if x.ndim < 2 or x.shape[1] < 2 or x[0, 0].numel() == 0 or x.shape[0] == 0:
        raise ValueError(f"batch_absdiff_cuda takes (B, T >= 2, ...) with elements, got {tuple(x.shape)}")
    B, T = x.shape[:2]
    if B > 65535:
        raise ValueError(f"batch_absdiff_cuda takes at most 65535 batch rows, got {B}")
    if _fn is None:
        _resolve()
    xf = x if x.dtype == torch.float32 else x.float()
    if not xf.is_contiguous():
        xf = xf.contiguous()
    y = torch.empty(B, T, device=x.device, dtype=torch.float32)
    err = _build.launch(_fn, x.device, xf.data_ptr(), y.data_ptr(), B, T, x[0, 0].numel())
    if err != 0:
        raise RuntimeError(f"absdiff kernel launch failed: cudaError {err}")
    launches += 1
    return y if x.dtype == torch.float32 else y.to(x.dtype)
