"""ctypes binding of the CUDA absdiff kernel (csrc/absdiff.cu).

Replaces the TPU kernel ``ssar_tpu/ops/absdiff.py`` (``_absdiff_kernel`` /
``absdiff_pallas``).  The wrapper checks device, dtype and shape, allocates
the output, launches once for the whole batch on PyTorch's current stream
(``_build.launch``) and raises if the launch is refused.  float32, float16
and bfloat16 are read as they are (widened to float32 in registers, summed
in float32, the result rounded to the input's dtype); another floating dtype
is cast to float32 for the launch and the result back, as ``absdiff_pallas``
does.  The kernel's plan (csrc/absdiff.cu ``make_plan``) aims at the card's
SM count; a split plan needs a scratch buffer of ticket counters and partial
sums, kept per device and stream so that two calls that could run at once
never share one.  ``launches`` counts the launches made through it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

launches = 0

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
PLAN_KEYS = ("vec", "units", "threads", "tc", "chunks", "slices", "per_slice")

_fn = _plan = None
_scratch_bytes = None
_scratch: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}  # (device, stream) -> (scratch, SM count)


def bind(lib: ctypes.CDLL):
    """Set the argument types of csrc/absdiff.cu's entry points in ``lib``;
    returns (ssar_absdiff, ssar_absdiff_scratch_bytes, ssar_absdiff_plan)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn, size, plan = lib.ssar_absdiff, lib.ssar_absdiff_scratch_bytes, lib.ssar_absdiff_plan
    fn.argtypes = [P, P, I, I, I, L, I, P, L, P]
    size.argtypes = [I]
    plan.argtypes = [I, I, L, I, I, I, ctypes.POINTER(L)]
    fn.restype = plan.restype = I
    size.restype = L
    return fn, size, plan


def _resolve():
    """Build (at first use) and bind the entry points."""
    global _fn, _scratch_bytes, _plan
    _fn, _scratch_bytes, _plan = bind(_build.load("absdiff"))


def plan_of(plan_fn, shape, dtype: torch.dtype, aligned: bool, sms: int) -> dict:
    """``ssar_absdiff_plan`` (bound as ``plan_fn``) for x of ``shape`` (B, T, ...)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    if plan_fn(shape[0], shape[1], math.prod(shape[2:]), DTYPE_CODES[dtype], int(aligned), sms, out) != 0:
        raise ValueError(f"no absdiff plan for {tuple(shape)} {dtype}")
    return dict(zip(PLAN_KEYS, out))


def plan(x: torch.Tensor) -> dict:
    """The kernel's plan for a call on ``x`` (float32, float16 or bfloat16,
    contiguous, on the card): ``PLAN_KEYS`` (csrc/absdiff.cu ``make_plan``)."""
    if _fn is None:
        _resolve()
    return plan_of(_plan, x.shape, x.dtype, x.data_ptr() % 16 == 0, _scratch_for(x.device)[1])


def _scratch_for(device: torch.device) -> tuple[torch.Tensor, int]:
    key = (device.index, _build.current_stream(device))
    found = _scratch.get(key)
    if found is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        # zeroed once, on the stream it serves: the kernel leaves its counters at 0
        found = _scratch[key] = (torch.zeros(_scratch_bytes(sms), dtype=torch.uint8, device=device), sms)
    return found


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
    if _fn is None:
        _resolve()
    xk = x if x.dtype in DTYPE_CODES else x.float()
    if not xk.is_contiguous():
        xk = xk.contiguous()
    scratch, sms = _scratch_for(x.device)
    y = torch.empty(B, T, device=x.device, dtype=xk.dtype)
    err = _build.launch(_fn, x.device, xk.data_ptr(), y.data_ptr(), DTYPE_CODES[xk.dtype], B, T, x[0, 0].numel(),
                        sms, scratch.data_ptr(), scratch.numel())
    if err != 0:
        raise RuntimeError(f"absdiff kernel launch failed: cudaError {err}")
    launches += 1
    return y if y.dtype == x.dtype else y.to(x.dtype)
