"""ctypes binding of the CUDA absdiff kernel (csrc/absdiff.cu).

Replaces the TPU kernel ``ssar_tpu/ops/absdiff.py`` (``_absdiff_kernel`` /
``absdiff_pallas``).  The wrapper checks device, dtype and shape, allocates
the output, launches once for the whole batch on PyTorch's current stream and
raises if the launch is refused.  ``launches`` counts the launches made
through it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _fn():
    lib = _build.load("absdiff")
    fn = lib.ssar_absdiff_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def batch_absdiff_cuda(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) float32 on the card -> (B, T): per batch row, the summed
    |x[t+1] - x[t]| over all trailing elements, with y[T-1] = y[T-2]."""
    global launches
    if not x.is_cuda:
        raise ValueError("batch_absdiff_cuda takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"batch_absdiff_cuda takes float32, got {x.dtype}")
    if x.ndim < 2 or x.shape[1] < 2 or x[0, 0].numel() == 0 or x.shape[0] == 0:
        raise ValueError(f"batch_absdiff_cuda takes (B, T >= 2, ...) with elements, got {tuple(x.shape)}")
    B, T = x.shape[:2]
    if B > 65535:
        raise ValueError(f"batch_absdiff_cuda takes at most 65535 batch rows, got {B}")
    x = x.contiguous()
    y = torch.empty(B, T, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), y.data_ptr(), B, T, x[0, 0].numel(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"absdiff kernel launch failed: cudaError {err}")
    launches += 1
    return y
