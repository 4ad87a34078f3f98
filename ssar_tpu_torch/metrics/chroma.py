"""Chromatic audio-reactivity metric.

Counterpart of ``ssar_tpu/metrics/chroma.py``: the self-similarity matrix of
the audio's chroma-CENS (nearest-neighbour median filtered, smoothed,
clipped) and that of the video's per-frame RGB histograms are compared by the
correlation of their strict upper triangles (optionally of soft ranks).  The
harmonic part's HPSS runs the sliding-median kernel (B1) on the card.

Two orders follow the reference exactly: the k nearest frames are the k most
similar with the lower frame index first among equal similarities (a stable
descending sort, as ``jax.lax.top_k``), and the median of the even number of
neighbours is the mean of the two middle values (``jnp.median``'s midpoint;
``torch.median`` returns the lower one).
"""
from __future__ import annotations

import math

import torch

from ..audio.features import harmonic
from ..audio.spectral import chroma_cens
from ..ops.gaussian import gaussian_filter
from ..ops.quantile import quantile
from ..utils.device import full_precision, resolve_device
from ..video.features import _histc_rows
from .correlation import soft_rank
from .rhythmic import _audio_at_rate, percentile_clip


def _median_midpoint(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.median``: (lower middle + upper middle) * 0.5 of the sorted values."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def nn_filter_cosine_median(S: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Each frame of S (D, T) replaced by the elementwise median of its k most
    cosine-similar frames, itself included; k defaults to
    min(T, 2 ceil(sqrt(T)))."""
    D, T = S.shape
    if k is None:
        k = min(T, 2 * math.ceil(math.sqrt(T)))
    norm = S / (torch.linalg.vector_norm(S, dim=0, keepdim=True) + 1e-12)
    sim = norm.T @ norm
    idx = torch.sort(sim, dim=1, descending=True, stable=True).indices[:, :k]
    neigh = S.T[idx]  # (T, k, D)
    return _median_midpoint(neigh, dim=1).T


def corrcoef(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    pred_n = pred - pred.mean()
    target_n = target - target.mean()
    pred_n = pred_n / (torch.linalg.vector_norm(pred_n) + 1e-12)
    target_n = target_n / (torch.linalg.vector_norm(target_n) + 1e-12)
    return (pred_n * target_n).sum()


def correlation(target: torch.Tensor, pred: torch.Tensor, spearman: bool = False,
                regularization_strength: float = 0.01) -> torch.Tensor:
    if spearman:
        pred = soft_rank(pred, regularization_strength) / pred.shape[-1]
    return corrcoef(target, pred)


def _frame_histograms(video: torch.Tensor, bins: int = 32) -> torch.Tensor:
    """(T, C, H, W) -> (T, C * bins): each frame's channels' histograms over
    their own [min, max] (``torch.histc``'s range)."""
    T, C = video.shape[:2]
    return _histc_rows(video.reshape(T * C, -1), bins).reshape(T, C * bins)


def chromatic_reactivity(audio, sr: int, video, fps: int, spearman: bool = False, device=None) -> torch.Tensor:
    """Correlation of the chroma and the RGB-histogram self-similarities of
    `audio` ((L,) or (channels, L)) and `video` ((T, C, H, W) in [0, 1]) over
    their common length: a 0-d tensor in [-1, 1].  Runs on `device` (the card
    unless ``device="cpu"``) with TF32 off."""
    device = resolve_device(device)
    with full_precision():
        audio, sr = _audio_at_rate(audio, sr, fps, device)
        video = torch.as_tensor(video, dtype=torch.float32).to(device)

        chroma = chroma_cens(harmonic(audio), sr)  # (12, T)
        chroma = nn_filter_cosine_median(chroma).T
        chroma = gaussian_filter(chroma, fps / 12)
        chroma = percentile_clip(chroma, 97.5)
        chroma = torch.clamp(torch.maximum(chroma, quantile(chroma, 0.1)), max=1.0)
        chroma = gaussian_filter(chroma, fps / 24)
        chroma = chroma / (torch.linalg.vector_norm(chroma, dim=1, keepdim=True) + 1e-12)

        vhist = _frame_histograms(video)
        vhist = vhist / (torch.linalg.vector_norm(vhist, dim=1, keepdim=True) + 1e-12)

        n = min(chroma.shape[0], vhist.shape[0])
        chroma, vhist = chroma[:n], vhist[:n]
        iu = torch.triu_indices(n, n, offset=1, device=device)
        chroma_ac = (chroma @ chroma.T)[iu[0], iu[1]]
        vhist_ac = (vhist @ vhist.T)[iu[0], iu[1]]
        return correlation(chroma_ac, vhist_ac, spearman=spearman)
