"""upfirdn2d and fused bias + leaky ReLU, StyleGAN2's two resampling ops.

Counterpart of ``ssar_tpu/ops/upfirdn.py`` in NCHW: zero-insertion
upsampling, padding, a depthwise FIR convolution and an output stride.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_blur_kernel(k=(1, 3, 3, 1)) -> np.ndarray:
    """Normalised separable outer-product FIR kernel."""
    k = np.asarray(k, dtype=np.float32)
    kernel = np.outer(k, k)
    return kernel / kernel.sum()


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """(B, C, H, W): upsample x`up` (zero insertion, H*up samples), pad, FIR, downsample x`down`.

    Per spatial axis: out = (H * up + pad0 + pad1 - (kh - 1) + down - 1) // down.
    """
    B, C, H, W = x.shape
    if up > 1:
        z = x.new_zeros(B, C, H, up, W, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(B, C, H * up, W * up)
    pad0, pad1 = pad
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    kh, kw = kernel.shape
    k = torch.flip(kernel, (0, 1)).to(dtype=x.dtype, device=x.device)  # true convolution
    return F.conv2d(x, k.expand(C, 1, kh, kw), stride=down, groups=C)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None, negative_slope: float = 0.2,
                     scale: float = float(np.sqrt(2))) -> torch.Tensor:
    """bias (over the channel axis: 1 of NCHW, else the last) + leaky ReLU + gain."""
    if bias is not None:
        x = x + (bias.reshape(1, -1, 1, 1) if x.ndim == 4 else bias)
    return F.leaky_relu(x, negative_slope) * scale


def upsample2x(x: torch.Tensor, blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """StyleGAN2's ``Upsample``: upfirdn(up=2, k*4, pad=(p+1)//2 + 1, p//2)."""
    k = make_blur_kernel(blur_kernel) * 4.0
    p = k.shape[0] - 2
    return upfirdn2d(x, torch.as_tensor(k), up=2, pad=((p + 1) // 2 + 1, p // 2))


def downsample2x(x: torch.Tensor, blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """StyleGAN2's ``Downsample``: upfirdn(down=2, k, pad=(p+1)//2, p//2).

    The separable blur is taken as weighted sums of strided slices, one axis
    after the other, not as a grouped convolution: the discriminator's R1
    penalty differentiates this twice, and the double backward of a grouped
    convolution runs one convolution a channel (2.5 s a calibration step at
    256 px on an H100)."""
    k1 = np.asarray(blur_kernel, dtype=np.float64)
    k1 = (k1 / k1.sum())[::-1]   # a true convolution; the outer product is make_blur_kernel's
    p = len(k1) - 2
    x = F.pad(x, ((p + 1) // 2, p // 2, (p + 1) // 2, p // 2))
    for axis in (-1, -2):
        n = (x.shape[axis] - len(k1)) // 2 + 1
        taps = [x.narrow(axis, i, 2 * n - 1)[..., ::2] if axis == -1 else x.narrow(axis, i, 2 * n - 1)[..., ::2, :]
                for i in range(len(k1))]
        x = sum(float(w) * t for w, t in zip(k1, taps))
    return x
