"""Training losses: procrustes self-supervision, MSE supervision, grad-norm.

Counterpart of ``ssar_tpu/train/losses.py``:
- ``orthogonal_procrustes_distance``: 1 - ||x'y||_nuc for centred,
  unit-norm x and y, the nuclear norm taken as sum sqrt(eigvals) of the
  smaller Gram side of x'y, batched over a leading axis (the JAX ``vmap``);
- ``audio_reactive_loss``: per-batch procrustes between concatenated
  flattened feature lists;
- ``normalize_gradients``: identity forward, backward rescaled to
  ``strength`` / ||grad||;
- ``supervised_loss`` / ``supervised_loss_per_example``: summed MSEs.
"""
from __future__ import annotations

import torch


def orthogonal_procrustes_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (..., T, Dx), y (..., T, Dy) -> (...) distances in [0, 2]."""
    x = x - x.mean(dim=-2, keepdim=True)
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-12)
    y = y - y.mean(dim=-2, keepdim=True)
    y = y / (torch.linalg.vector_norm(y, dim=(-2, -1), keepdim=True) + 1e-12)
    a = x.transpose(-1, -2) @ y
    m = a @ a.transpose(-1, -2) if a.shape[-2] <= a.shape[-1] else a.transpose(-1, -2) @ a
    ev = torch.linalg.eigvalsh(m)
    s = torch.sqrt(torch.clamp(ev, min=0.0) + 1e-24)  # |eps err| <= d * 1e-12
    return 1.0 - s.sum(dim=-1)


def _flat(feats) -> torch.Tensor:
    if isinstance(feats, dict):
        feats = list(feats.values())
    return torch.cat([f.reshape(f.shape[0], f.shape[1], -1) for f in feats], dim=2)


def audio_reactive_loss(afeats, vfeats) -> torch.Tensor:
    """Lists (or dicts) of (B, T, ...) tensors -> (B,) procrustes distances.
    Each list is concatenated along the flattened feature axis."""
    return orthogonal_procrustes_distance(_flat(afeats), _flat(vfeats))


class _NormalizeGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, strength: float):
        ctx.strength = strength
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.strength * g / (torch.linalg.vector_norm(g) + 1e-8), None


def normalize_gradients(x: torch.Tensor, strength: float = 1.0) -> torch.Tensor:
    """Identity forward; backward rescales the gradient to strength / ||grad||."""
    return _NormalizeGradients.apply(x, strength)


def supervised_loss(pred_latents, pred_noise, latents, noise_targets) -> torch.Tensor:
    """Sum of MSEs over latents + noise pyramid."""
    loss = torch.mean((pred_latents - latents) ** 2)
    for p, t in zip(pred_noise, noise_targets):
        loss = loss + torch.mean((p - t) ** 2)
    return loss


def supervised_loss_per_example(pred_latents, pred_noise, latents, noise_targets) -> torch.Tensor:
    """Per-window (B,) variant of ``supervised_loss``."""
    loss = torch.mean((pred_latents - latents) ** 2, dim=tuple(range(1, pred_latents.ndim)))
    for p, t in zip(pred_noise, noise_targets):
        loss = loss + torch.mean((p - t) ** 2, dim=tuple(range(1, p.ndim)))
    return loss
