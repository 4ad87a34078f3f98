"""Gaussian temporal smoothing along the frame axis.

Counterpart of ``ssar_tpu/ops/gaussian.py``: a 1-D gaussian of radius
``min(int(sigma * 4), 3 * T)`` convolved along axis 0, circular padding by
default, as one depthwise ``conv1d`` with every non-time element folded into
the batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_PAD_MODE = {"circular": "circular", "reflect": "reflect", "replicate": "replicate",
             "constant": "constant"}


def gaussian_kernel(sigma: float, radius: int, dtype=torch.float32, device=None) -> torch.Tensor:
    t = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 / (sigma**2) * t**2)
    return k / k.sum()


def gaussian_filter(x: torch.Tensor, sigma: float, mode: str = "circular") -> torch.Tensor:
    """Smooth `x` along axis 0 with a gaussian of std `sigma` (frames).

    Accepts (T,), (T, C), (T, C, H, W)...; inputs of ndim <= 2 have trailing
    singleton axes squeezed, as the JAX reference does.
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
        flat = F.pad(flat, (T, T), mode=_PAD_MODE[mode])
        flat = F.pad(flat, (radius - T, radius - T), mode="replicate")
    else:
        flat = F.pad(flat, (radius, radius), mode=_PAD_MODE[mode])

    out = F.conv1d(flat, kernel[None, None, :])
    out = out[:, 0, :].T.reshape(in_shape).to(x.dtype)
    if in_ndim <= 2:
        while out.ndim > 1 and out.shape[-1] == 1:
            out = out[..., 0]
    return out
