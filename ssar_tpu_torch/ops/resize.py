"""Image and sequence resizing with ``jax.image.resize``'s semantics.

Counterpart of the ``jax.image.resize(x, shape, "bilinear")`` calls of the
JAX package (``gan/wrapper.py``, later the patch system and the metrics):
half-pixel centres, the triangle kernel, and on downsampling the kernel
widened by the scale (antialiasing).  Both resize one axis at a time, so each
axis whose size changes is one ``F.interpolate(mode="bilinear",
antialias=...)`` over (rows, 1, 1, size): PyTorch's antialiased kernel
computes the same weights.  One call over two axes at once is not used: with
an output one sample wide it upsamples the other axis wrongly (PyTorch
2.13, CPU).  A plain op: the reference computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_LINEAR = ("linear", "bilinear", "trilinear", "triangle")


def resize(x: torch.Tensor, shape, method: str = "linear", antialias: bool = True) -> torch.Tensor:
    """`x` resized to `shape` (one size per axis, as ``jax.image.resize``
    takes it), computed in float32 and returned in `x`'s floating dtype;
    axes whose size is unchanged are left as they are.  Only the linear
    (triangle) kernel is ported."""
    if method not in _LINEAR:
        raise ValueError(f"resize ports the linear kernel only ({_LINEAR}), got {method!r}")
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} must have one size per axis of x {tuple(x.shape)}")
    dtype = x.dtype if x.is_floating_point() else torch.float32
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            rows = x.movedim(d, -1)
            out = F.interpolate(rows.reshape(-1, 1, 1, n_in).float(), size=(1, n_out), mode="bilinear",
                                align_corners=False, antialias=antialias)
            x = out.reshape(*rows.shape[:-1], n_out).movedim(-1, d)
    return x.to(dtype)
