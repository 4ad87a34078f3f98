"""StyleGAN2's styled-conv epilogue: what follows the convolution in every styled conv.

``styled_epilogue(y, demod, noise, noise_weight, bias, up=..., blur_kernel=...)``
takes the raw output of the layer's convolution, ``y``: (B, C, H, W) from
``conv2d`` or, when ``up``, (B, C, 2H + 1, 2H + 1) from the stride-2
``conv_transpose2d``, and computes, in this order,

- when ``up``, the blur: pad ((p + 1) // 2 + 1, p // 2 + 1) with p =
  len(blur_kernel) - 2 - (kernel_size - 1) and convolve with
  ``make_blur_kernel(blur_kernel) * 4`` (``ops/upfirdn.py:upfirdn2d``);
- ``* demod[b, c]`` (float32 (B, C), or None), ``+ noise_weight * noise``
  (noise (B, 1, H', W') or None, noise_weight a 0-d tensor) and ``+ bias[c]``
  (float32 (C,), or None);
- the leaky ReLU 0.2 and the gain sqrt(2) (``fused_leaky_relu``).

``plain`` is that composition op for op, each pass in the activation's
dtype, as ``gan/stylegan2.py`` ran it: the CPU path, and what the card
tests hold kernel E1 to.  On a CUDA tensor the op is one launch of E1
(``csrc/styled_epilogue.cu``), which reads ``y`` once and writes the
activation once, float32 arithmetic with one rounding to the dtype; the
scalars are read from device memory by pointer and the blur's taps are the
launch's parameters (built once a blur on the host), so no call copies to
the card or waits for it.  E1 takes float32, float16 and bfloat16, a blur
of 1 to 8 taps, ``y`` in any layout (a channels-last convolution output,
which a channels-last input gives, such as a ``const`` loaded in the JAX
layout, is made contiguous first) and a noise of any strides (a batch of
one is read with a batch stride of 0, a row of adjacent samples as whole
vectors; another dtype is cast to ``y``'s, as the plain version casts it),
and raises on anything else.  Under
autograd on a card the op is a ``torch.autograd.Function``: E1 forward, the
plain composition's VJP, recomputed from the saved inputs, backward.

Counters: ``calls`` (ops applied), ``least_bytes`` (each call's input,
noise and output once each at their dtypes: the least that any
implementation moves) and ``launches`` (E1 launches; on a card every call
is one).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .upfirdn import fused_leaky_relu, make_blur_kernel, upfirdn2d

calls = 0
least_bytes = 0
launches = 0

MAX_TAPS = 8
SLOPE = 0.2
GAIN = float(np.sqrt(2))
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_fn = None     # the library's ssar_styled_epilogue, once bound
_taps: dict = {}   # blur_kernel -> its flipped 1-D taps times 2 as a ctypes float array


def reset_counters() -> None:
    global calls, least_bytes, launches
    calls = least_bytes = launches = 0


def bind(lib: ctypes.CDLL):
    """The library's entry point with its argument types."""
    fn = lib.ssar_styled_epilogue
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong] \
        + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _card_entry(device: torch.device):
    global _fn
    if _fn is None:
        _fn = bind(_build.load("styled_epilogue"))
    return lambda *args: _build.launch(_fn, device, *args)


def blur_pad(blur_kernel, kernel_size: int) -> tuple[int, int]:
    """The up-conv's padding before its blur (rosinality's ``Blur`` after a
    transposed conv of `kernel_size`)."""
    p = (len(blur_kernel) - 2) - (kernel_size - 1)
    return (p + 1) // 2 + 1, p // 2 + 1


def launch_taps(blur_kernel) -> ctypes.Array:
    """E1's taps of a blur: ``make_blur_kernel(k) * 4`` is the outer product
    of ``2 k / sum(k)`` with itself; flipped (a true convolution), in
    float32, built once a blur."""
    key = tuple(float(v) for v in blur_kernel)
    if key not in _taps:
        k = np.asarray(key, np.float64)
        taps = (2.0 * k / k.sum())[::-1].astype(np.float32)
        _taps[key] = (ctypes.c_float * len(taps))(*[float(v) for v in taps])
    return _taps[key]


def plain(y: torch.Tensor, demod: torch.Tensor | None, noise: torch.Tensor | None, noise_weight: torch.Tensor,
          bias: torch.Tensor | None, *, up: bool, blur_kernel=(1, 3, 3, 1), kernel_size: int = 3) -> torch.Tensor:
    """The epilogue as separate passes in ``y``'s dtype (the CPU path and E1's reference)."""
    out = y
    if up:
        k = torch.as_tensor(make_blur_kernel(blur_kernel) * 4.0)
        out = upfirdn2d(out, k, pad=blur_pad(blur_kernel, kernel_size))
    if demod is not None:
        out = out * demod.to(out.dtype)[:, :, None, None]
    if noise is not None:
        out = out + noise_weight.to(out.dtype) * noise.to(out.dtype)
    return fused_leaky_relu(out, None if bias is None else bias.to(out.dtype), SLOPE, GAIN)


def out_shape(y: torch.Tensor, up: bool, blur_kernel, kernel_size: int) -> tuple[int, ...]:
    """The epilogue's output shape for the convolution's output ``y``."""
    if not up:
        return tuple(y.shape)
    pad0, pad1 = blur_pad(blur_kernel, kernel_size)
    n = len(blur_kernel)
    return (*y.shape[:2], y.shape[2] + pad0 + pad1 - n + 1, y.shape[3] + pad0 + pad1 - n + 1)


def launch(y: torch.Tensor, demod: torch.Tensor | None, noise: torch.Tensor | None, noise_weight: torch.Tensor,
           bias: torch.Tensor | None, *, up: bool, blur_kernel=(1, 3, 3, 1), kernel_size: int = 3,
           entry=None) -> torch.Tensor:
    """The epilogue by one launch of E1 through ``entry(*args)`` (the
    library's ``ssar_styled_epilogue`` with the stream bound; the card's when
    None), after checking the tensors; the output from ``torch.empty``."""
    global launches
    if y.dtype not in DTYPES:
        raise TypeError(f"styled_epilogue: E1 takes float32, float16 or bfloat16, not {y.dtype}")
    if y.ndim != 4:
        raise ValueError(f"styled_epilogue: y must be a (B, C, H, W) tensor, not {tuple(y.shape)}")
    y = y.contiguous()   # a channels-last convolution output (from a channels-last input) is copied once
    B, C = y.shape[:2]
    if up and not 1 <= len(blur_kernel) <= MAX_TAPS:
        raise ValueError(f"styled_epilogue: E1 takes a blur of 1 to {MAX_TAPS} taps, not {len(blur_kernel)}")
    shape = out_shape(y, up, blur_kernel, kernel_size)
    if min(shape[2:]) <= 0:
        raise ValueError(f"styled_epilogue: an input of {tuple(y.shape[2:])} gives no output")

    def check(t, name, want):
        if t is not None and (t.device != y.device or t.dtype != torch.float32 or tuple(t.shape) != want
                              or not t.is_contiguous()):
            raise ValueError(f"styled_epilogue: {name} must be a contiguous float32 {want} on {y.device}, not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")

    check(demod, "demod", (B, C))
    check(bias, "bias", (C,))
    if noise is not None:
        check(noise_weight, "noise_weight", ())
        if noise.ndim != 4 or noise.shape[0] not in (1, B) or tuple(noise.shape[1:]) != (1, *shape[2:]) \
                or noise.device != y.device:
            raise ValueError(f"styled_epilogue: a noise of {tuple(noise.shape)} on {noise.device} for an output of "
                             f"{shape} on {y.device}")
        noise = noise.to(y.dtype)
    out = torch.empty(shape, device=y.device, dtype=y.dtype)
    taps = launch_taps(blur_kernel) if up else None
    entry = entry or _card_entry(y.device)
    err = entry(DTYPES[y.dtype], int(up), y.data_ptr(), out.data_ptr(), None if demod is None else demod.data_ptr(),
                None if noise is None else noise.data_ptr(),
                None if noise is None else noise_weight.data_ptr(), None if bias is None else bias.data_ptr(),
                None if taps is None else ctypes.addressof(taps), len(blur_kernel) if up else 0, B * C, C,
                *y.shape[2:], *shape[2:], blur_pad(blur_kernel, kernel_size)[0] if up else 0,
                *((0, 0, 0) if noise is None else (0 if noise.shape[0] == 1 else noise.stride(0), *noise.stride()[2:])),
                SLOPE, GAIN)
    if err != 0:
        raise RuntimeError(f"styled_epilogue launch failed: cudaError {err}")
    launches += 1
    return out


class _E1(torch.autograd.Function):
    """E1 forward; backward the VJP of ``plain``, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, y, demod, noise, noise_weight, bias, spec):
        ctx.save_for_backward(y, demod, noise, noise_weight, bias)
        ctx.spec = spec
        return launch(y, demod, noise, noise_weight, bias, **spec)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            out = plain(*ins, **ctx.spec)
        wanted = [t for t, need in zip(ins, needs) if need and t is not None]
        got = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))   # noise_weight without noise
        return (*[next(got) if need and t is not None else None for t, need in zip(ins, needs)], None)


def styled_epilogue(y: torch.Tensor, demod: torch.Tensor | None, noise: torch.Tensor | None,
                    noise_weight: torch.Tensor, bias: torch.Tensor | None, *, up: bool, blur_kernel=(1, 3, 3, 1),
                    kernel_size: int = 3) -> torch.Tensor:
    """The styled conv's epilogue (module docstring): ``plain`` on the CPU,
    one launch of E1 on a card."""
    global calls, least_bytes
    spec = {"up": up, "blur_kernel": tuple(blur_kernel), "kernel_size": kernel_size}
    if y.device.type != "cuda":
        out = plain(y, demod, noise, noise_weight, bias, **spec)
    elif torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                         for t in (y, demod, noise, noise_weight, bias)):
        out = _E1.apply(y, demod, noise, noise_weight, bias, spec)
    else:
        out = launch(y, demod, noise, noise_weight, bias, **spec)
    calls += 1
    noise_bytes = 0 if noise is None else math.prod(noise.shape[-2:]) * noise.shape[0] * noise.element_size()
    least_bytes += (y.numel() + out.numel()) * y.element_size() + noise_bytes
    return out
