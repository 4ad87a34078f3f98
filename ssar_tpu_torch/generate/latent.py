"""Latent-sequence construction: spline loops and feature / segment patches.

Counterpart of ``ssar_tpu/generate/latent.py``: a base W+ sequence is a
natural cubic spline loop through palette latents; subpatches overlay
segmentation-, feature- or loop-driven sequences onto bands of W+ layers by
averaging, modulation or overwrite.
"""
from __future__ import annotations

import torch

from ..ops.gaussian import gaussian_filter
from . import keys

MERGE_DEPTH_SLICES = {
    "low": slice(0, 6), "mid": slice(6, 12), "high": slice(12, 18),
    "lowmid": slice(0, 12), "midhigh": slice(6, 18), "all": slice(0, 18),
}


def linspace(stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32 as XLA computes it: the
    index times the step fl(stop * fl(1 / (num - 1))), the end point exact.
    The noise loops magnify an ulp of their phase ~10x, so the phase follows
    the reference's rounding rather than ``torch.linspace``'s."""
    if num <= 1:
        return torch.zeros(num, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    step = stop_t * torch.tensor(1.0 / (num - 1), dtype=torch.float32)
    return torch.cat([torch.arange(num - 1, dtype=torch.float32) * step, stop_t[None]]).to(device)


def natural_cubic_spline(t_in: torch.Tensor, y: torch.Tensor, t_out: torch.Tensor) -> torch.Tensor:
    """Natural cubic spline through (t_in, y) evaluated at t_out.

    y: (n, ...) values; returns (len(t_out), ...).  The system for the second
    derivatives is tiny (n <= ~20 knots) and solved densely."""
    n = y.shape[0]
    shape = y.shape[1:]
    yf = y.reshape(n, -1)
    dev, dt = y.device, y.dtype
    h = t_in[1:] - t_in[:-1]  # (n - 1,)

    A = torch.zeros((n, n), dtype=dt, device=dev)
    A[0, 0] = A[n - 1, n - 1] = 1.0
    rows = torch.arange(1, n - 1, device=dev)
    A[rows, rows - 1] = h[:-1]
    A[rows, rows] = 2.0 * (h[:-1] + h[1:])
    A[rows, rows + 1] = h[1:]
    d = torch.zeros((n, yf.shape[1]), dtype=dt, device=dev)
    slope = (yf[1:] - yf[:-1]) / h[:, None]
    d[1:-1] = 6.0 * (slope[1:] - slope[:-1])
    m = torch.linalg.solve(A, d)  # (n, F)

    idx = torch.clamp(torch.searchsorted(t_in, t_out, right=True) - 1, 0, n - 2)
    x0 = t_in[idx]
    hi = h[idx][:, None]
    a = (t_in[idx + 1] - t_out)[:, None] / hi
    b = (t_out - x0)[:, None] / hi
    out = (a * yf[idx] + b * yf[idx + 1]
           + ((a**3 - a) * m[idx] + (b**3 - b) * m[idx + 1]) * hi**2 / 6.0)
    return out.reshape((len(t_out),) + tuple(shape))


def spline_loop_latents(y: torch.Tensor, size: int, n_loops: float = 1.0) -> torch.Tensor:
    """Closed spline loop through latents y (n, n_ws, 512) -> (size, n_ws, 512)."""
    y = torch.cat([y, y[:1]], dim=0)
    t_in = linspace(1.0, y.shape[0], y.device)
    t_out = linspace(n_loops, size, y.device) % 1.0
    return natural_cubic_spline(t_in, y, t_out)


def latent_patch(key, latents, palette, segmentations, features, tempo, fps, *,
                 patch_type, segments, loop_bars, seq_feat, seq_feat_weight,
                 mod_feat, mod_feat_weight, merge_type, merge_depth):
    """Apply one random latent subpatch; returns new latents."""
    feature = seq_feat_weight * features[seq_feat]
    segmentation = segmentations[(seq_feat, segments)]
    permutation = keys.permutation(key, palette.shape[0]).to(palette.device)

    if patch_type == "segmentation":
        selection = permutation[:segments]
        labels = segmentation.argmax(dim=1) if segmentation.ndim == 2 else segmentation
        sequence = palette[selection[labels.to(palette.device).long()]]
        sequence = gaussian_filter(sequence, 5)
    elif patch_type == "feature":
        n_select = feature.shape[1]
        if n_select == 1:
            selection = permutation[:2]
            sequence = feature[..., None] * palette[selection][0:1] \
                + (1 - feature[..., None]) * palette[selection][1:2]
        else:
            selection = permutation[:n_select]
            sequence = torch.einsum("TN,NWL->TWL", feature, palette[selection])
    elif patch_type == "loop":
        selection = permutation[:segments]
        n_loops = latents.shape[0] / fps / 60 / tempo / 4 / loop_bars
        sequence = spline_loop_latents(palette[selection], latents.shape[0], n_loops=float(n_loops))
    else:
        raise ValueError(patch_type)
    sequence = gaussian_filter(sequence, 1)

    lays = MERGE_DEPTH_SLICES[merge_depth]
    latents = latents.clone()
    if merge_type == "average":
        latents[:, lays] = (latents[:, lays] + sequence[:, lays]) / 2
    elif merge_type == "modulate":
        modulation = (mod_feat_weight * features[mod_feat])[..., None]
        latents[:, lays] = latents[:, lays] * (1 - modulation) + modulation * sequence[:, lays]
    else:  # overwrite
        latents[:, lays] = sequence[:, lays]
    return latents
