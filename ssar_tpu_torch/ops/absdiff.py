"""Temporal absolute-difference envelope.

Counterpart of ``ssar_tpu/ops/absdiff.py``: for ``x`` of shape (T, ...),
``y[t] = sum(|x[t+1] - x[t]|)`` over all non-time elements for t < T-1, and
``y[T-1] = y[T-2]``.  ``batch_absdiff`` takes (B, T, ...) with the batch
written out (the JAX trainer's ``vmap``) and makes one launch per batch.

On a CUDA tensor the forward runs the hand-written kernel
(``absdiff_cuda.py``, ``csrc/absdiff.cu``: float32, float16 and bfloat16
read as they are, another floating dtype through float32) and raises on a
build or launch failure; on a CPU tensor it runs the plain version in the
input's dtype.  The backward is the JAX
package's analytic sign-based one (plain there too), in plain torch.
"""
from __future__ import annotations

import torch


def batch_absdiff_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B, T) (any device)."""
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    d = (flat[:, 1:] - flat[:, :-1]).abs().sum(dim=2)
    return torch.cat([d, d[:, -1:]], dim=1)


def absdiff_plain(x: torch.Tensor) -> torch.Tensor:
    """(T, ...) -> (T,), the plain version (``absdiff_ref``)."""
    return batch_absdiff_plain(x[None])[0]


def _absdiff_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    s = torch.sign(flat[:, 1:] - flat[:, :-1])  # (B, T-1, E)
    # y[T-1] duplicates y[T-2]: fold its gradient into the source row
    gt = g[:, :-1].clone()
    gt[:, -1] += g[:, -1]
    sg = s * gt[:, :, None]
    gx = torch.zeros_like(flat)
    gx[:, 1:] += sg
    gx[:, :-1] -= sg
    return gx.reshape(x.shape)


class _BatchAbsdiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.is_cuda:
            from .absdiff_cuda import batch_absdiff_cuda

            return batch_absdiff_cuda(x)
        return batch_absdiff_plain(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _absdiff_bwd(x, g)


def batch_absdiff(x: torch.Tensor) -> torch.Tensor:
    """Differentiable (B, T, ...) -> (B, T), in the input's floating dtype."""
    if x.ndim < 2 or x.shape[1] < 2:
        raise ValueError(f"batch_absdiff takes (B, T >= 2, ...), got {tuple(x.shape)}")
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"batch_absdiff runs on CUDA or CPU tensors, got {x.device}")
    return _BatchAbsdiff.apply(x)


def absdiff(x: torch.Tensor) -> torch.Tensor:
    """Differentiable (T, ...) -> (T,), in the input's floating dtype."""
    return batch_absdiff(x[None])[0]
