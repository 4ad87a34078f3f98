"""ctypes bindings of the CUDA sliding-median kernels (csrc/sliding_median.cu,
csrc/sliding_median_bwd.cu).

Replace the TPU kernel ``ssar_tpu/ops/median_pallas.py``
(``_median_kernel`` / ``sliding_median_lastaxis``) and its VJP
(``_sliding_median_bwd``).  Each wrapper checks device, dtype and shape,
allocates the output, launches on PyTorch's current stream and raises if the
launch is refused.  Widths up to ``MAX_K`` run the sources' templated
kernels; a wider odd width runs their generic kernels (k a run-time argument,
one thread an output or an input: the Pallas kernel takes any odd k).
``launches`` and ``bwd_launches`` count the templated kernels' launches made
through them, ``generic_launches`` and ``generic_bwd_launches`` the generic
ones'.

The optimizer calls these thousands of times on matrices of a few thousand
elements, where the host's time in the wrapper is several times the kernel's,
so a call does only what it needs: the ctypes functions are resolved once, a
contiguous tensor is not passed through ``.contiguous()``, the stream is read
as a raw handle, and the device guard is entered only for a tensor that is not
on the current device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MAX_K = 31  # widths instantiated in the sources: every odd k in [1, 31]; wider ones are generic

launches = 0
bwd_launches = 0
generic_launches = 0
generic_bwd_launches = 0

_LAYOUT_ARGS = [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 4
_fwd_fn = None
_bwd_fn = None


def _resolve():
    """Build (at first use) and bind both entry points."""
    global _fwd_fn, _bwd_fn
    fwd = _build.load("sliding_median").ssar_sliding_median_f32
    fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + _LAYOUT_ARGS + [ctypes.c_void_p]
    bwd = _build.load("sliding_median_bwd").ssar_sliding_median_bwd_f32
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + _LAYOUT_ARGS + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    _fwd_fn, _bwd_fn = fwd, bwd


def line_layout(shape, axis: int):
    """(n_lines, L, lines_per_batch, batch_stride, line_stride, pos_stride),
    in elements, of a contiguous tensor's lines along ``axis``: its last axis
    (``len(shape) - 1``) or the one before it.  Leading dimensions are a batch."""
    nb, R, T = (math.prod(shape[:-2]), shape[-2], shape[-1]) if len(shape) >= 2 else (1, 1, shape[0])
    if axis == len(shape) - 1:  # one line per (batch, row)
        return nb * R, T, R, R * T, T, 1
    return nb * T, R, T, R * T, 1, T  # one line per (batch, column)


def _check(x: torch.Tensor, k: int, axis: int, who: str) -> int:
    if not x.is_cuda:
        raise ValueError(f"{who} takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{who} takes float32, got {x.dtype}")
    if k % 2 != 1 or k < 1:
        raise ValueError(f"window width must be odd, got {k}")
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"{who} takes a non-empty tensor, got shape {tuple(x.shape)}")
    axis = axis % x.ndim
    if axis < x.ndim - 2:
        raise ValueError(f"{who} filters the last axis or the one before it")
    return axis


def sliding_median_cuda(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Median of the odd k-wide window along ``axis`` (the last or the one
    before it) of a CUDA float32 tensor, reflect padded (an axis of any
    length).  A window holding a NaN gives NaN.  Leading dimensions are a
    batch.  The axis before the last is filtered in place of its strides (no
    transpose copy)."""
    global launches, generic_launches
    axis = _check(x, k, axis, "sliding_median_cuda")
    if _fwd_fn is None:
        _resolve()
    if not x.is_contiguous():
        x = x.contiguous()
    y = torch.empty_like(x)
    err = _build.launch(_fwd_fn, x.device, x.data_ptr(), y.data_ptr(), k, *line_layout(x.shape, axis))
    if err != 0:
        raise RuntimeError(f"sliding_median kernel launch failed: cudaError {err}")
    if k > MAX_K:
        generic_launches += 1
    else:
        launches += 1
    return y


def sliding_median_bwd_cuda(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Gradient of ``sliding_median_cuda(x, k, axis)`` for the output
    cotangent ``g``: each ``g[t]`` goes to the first window tap equal to
    ``out[t]``, the reflect halo folded back.  ``out`` is the forward's result."""
    global bwd_launches, generic_bwd_launches
    axis = _check(x, k, axis, "sliding_median_bwd_cuda")
    if out.shape != x.shape or g.shape != x.shape or out.dtype != x.dtype or g.dtype != x.dtype \
            or out.device != x.device or g.device != x.device:
        raise ValueError(f"sliding_median_bwd_cuda: out {tuple(out.shape)} {out.dtype} {out.device} and g "
                         f"{tuple(g.shape)} {g.dtype} {g.device} must match x {tuple(x.shape)} {x.dtype} {x.device}")
    if _bwd_fn is None:
        _resolve()
    x, out, g = (t if t.is_contiguous() else t.contiguous() for t in (x, out, g))
    gx = torch.empty_like(x)
    err = _build.launch(_bwd_fn, x.device, x.data_ptr(), out.data_ptr(), g.data_ptr(), gx.data_ptr(), k,
                        *line_layout(x.shape, axis))
    if err != 0:
        raise RuntimeError(f"sliding_median_bwd kernel launch failed: cudaError {err}")
    if k > MAX_K:
        generic_bwd_launches += 1
    else:
        bwd_launches += 1
    return gx
