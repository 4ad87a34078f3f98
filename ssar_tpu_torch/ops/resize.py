"""Image and sequence resizing with ``jax.image.resize``'s semantics.

Counterpart of the ``jax.image.resize`` calls of the JAX package
(``gan/wrapper.py``, the patch system, later the metrics): half-pixel
centres, and on downsampling the kernel widened by the scale
(antialiasing).  Both resize one axis at a time.

- Linear (triangle kernel): each axis whose size changes is one
  ``F.interpolate(mode="bilinear", antialias=...)`` over (rows, 1, 1, size):
  PyTorch's antialiased kernel computes the same weights.  One call over two
  axes at once is not used: with an output one sample wide it upsamples the
  other axis wrongly (PyTorch 2.13, CPU).
- Cubic (Keys, a = -0.5): PyTorch's bicubic is another cubic (a = -0.75,
  clamped taps), so each axis is a product with the (in, out) weight matrix
  that ``jax/_src/image/scale.py:compute_weight_mat`` builds.

A plain op: the reference computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_LINEAR = ("linear", "bilinear", "trilinear", "triangle")
_CUBIC = ("cubic", "bicubic", "tricubic")


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) at |offsets| `x`."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int, antialias: bool = True, device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of the Keys cubic resize of one axis:
    half-pixel centres, the kernel widened by the scale on downsampling when
    `antialias`, each column divided by its sum where |sum| > 1000 eps (zero
    elsewhere), and zero where the sample lies outside [-0.5, n_in - 0.5]."""
    scale = torch.tensor(n_out / n_in, dtype=torch.float32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else torch.tensor(1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize(x: torch.Tensor, shape, method: str = "linear", antialias: bool = True) -> torch.Tensor:
    """`x` resized to `shape` (one size per axis, as ``jax.image.resize``
    takes it), computed in float32 and returned in `x`'s floating dtype;
    axes whose size is unchanged are left as they are.  `method` is linear
    (``"linear"``, ``"bilinear"``, ...) or Keys cubic (``"cubic"``, ...)."""
    if method not in _LINEAR + _CUBIC:
        raise ValueError(f"resize ports the linear and cubic kernels ({_LINEAR + _CUBIC}), got {method!r}")
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} must have one size per axis of x {tuple(x.shape)}")
    dtype = x.dtype if x.is_floating_point() else torch.float32
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        if method in _CUBIC:
            w = cubic_weights(n_in, n_out, antialias, x.device)
            x = torch.tensordot(x.float(), w, dims=([d], [0])).movedim(-1, d)
            continue
        rows = x.movedim(d, -1)
        out = F.interpolate(rows.reshape(-1, 1, 1, n_in).float(), size=(1, n_out), mode="bilinear",
                            align_corners=False, antialias=antialias)
        x = out.reshape(*rows.shape[:-1], n_out).movedim(-1, d)
    return x.to(dtype)
