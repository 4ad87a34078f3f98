# Frozen copy of ssar_tpu_torch/ops/gaussian.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Gaussian temporal smoothing along the frame axis.

Counterpart of ``ssar_tpu/ops/gaussian.py``: a 1-D gaussian of radius
``min(int(sigma * 4), 3 * T)`` convolved along axis 0, circular padding by
default, as one depthwise ``conv1d`` with every non-time element folded into
the batch.  The convolution runs in full float32 on the card (no TF32), as the
JAX filter pins ``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import full_precision
from .median import pad_indices, reflect_indices

_INDEX_MODE = {"circular": "wrap", "replicate": "edge"}


def gaussian_kernel(sigma: float, radius: int, dtype=torch.float32, device=None) -> torch.Tensor:
    t = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 / (sigma**2) * t**2)
    return k / k.sum()


def _pad(flat: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """`flat` padded by `p` on both ends of its last axis as ``jnp.pad`` pads
    in the matching mode, for any p (``F.pad`` refuses a reflect pad as long
    as the line, which the JAX package's short sequences reach)."""
    if mode == "constant":
        return F.pad(flat, (p, p))
    L = flat.shape[-1]
    if mode == "reflect":
        return flat.index_select(-1, reflect_indices(L, p, flat.device))
    return flat.index_select(-1, pad_indices(L, p, _INDEX_MODE[mode], flat.device))


def gaussian_filter(x: torch.Tensor, sigma: float, mode: str = "circular", causal: float = 1.0) -> torch.Tensor:
    """Smooth `x` along axis 0 with a gaussian of std `sigma` (frames).

    Accepts (T,), (T, C), (T, C, H, W)...; inputs of ndim <= 2 have trailing
    singleton axes squeezed, as the JAX reference does.  `causal` is taken
    for the reference's call surface and not used, as in the JAX package
    (the kernel is always symmetric).
    """
    in_ndim, in_shape = x.ndim, x.shape
    T = x.shape[0]
    radius = min(int(sigma * 4), 3 * T)
    if radius == 0:
        return x

    dtype = torch.promote_types(x.dtype, torch.float32)
    kernel = gaussian_kernel(sigma, radius, dtype, x.device)
    flat = x.reshape(T, -1).T[:, None, :].to(dtype)  # (B, 1, T)

    if radius > T:  # double pad for very short sequences
        flat = _pad(flat, T, mode)
        flat = _pad(flat, radius - T, "replicate")
    else:
        flat = _pad(flat, radius, mode)

    with full_precision():
        out = F.conv1d(flat, kernel[None, None, :])
    out = out[:, 0, :].T.reshape(in_shape).to(x.dtype)
    if in_ndim <= 2:
        while out.ndim > 1 and out.shape[-1] == 1:
            out = out[..., 0]
    return out
