"""Pitch tracking and tuning estimation (dense masks, no gathers).

Counterpart of ``ssar_tpu/audio/pitch.py``: parabolic-interpolated pitch
candidates for every bin with a validity mask, and the tuning deviation as
the argmax of a masked weighted residual histogram, all on the device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quantile import masked_quantile
from .spectral import spectrogram

_TINY = float(np.finfo(np.float32).tiny)


def piptrack(y: torch.Tensor, sr: int, n_fft: int = 2048, hop_length: int | None = None,
             fmin: float = 150.0, fmax: float = 4000.0, threshold: float = 0.1):
    """(pitches, mags, mask), dense (1 + n_fft//2, T); `mask` marks the bins a
    sparse pitch tracker would have kept."""
    if hop_length is None:
        hop_length = n_fft // 4
    S = spectrogram(y, n_fft=n_fft, hop_length=hop_length)
    fmin = max(fmin, 0.0)
    fmax = min(fmax, float(sr) / 2)
    fft_freqs = torch.linspace(0, float(sr) / 2, int(1 + n_fft // 2), device=S.device, dtype=S.dtype)

    avg = 0.5 * (S[2:] - S[:-2])
    shift_den = 2 * S[1:-1] - S[2:] - S[:-2]
    shift = avg / (shift_den + (shift_den.abs() < _TINY).to(S.dtype))
    avg = F.pad(avg, (0, 0, 1, 1))
    shift = F.pad(shift, (0, 0, 1, 1))
    dskew = 0.5 * avg * shift

    freq_mask = ((fmin <= fft_freqs) & (fft_freqs < fmax))[:, None]
    ref_value = threshold * S.max(dim=0).values
    Sm = S * (S > ref_value)
    Sm_pad = F.pad(Sm, (0, 0, 1, 1))
    localmax = (Sm > Sm_pad[:-2]) & (Sm >= Sm_pad[2:])

    mask = freq_mask & localmax
    bin_idx = torch.arange(S.shape[0], dtype=S.dtype, device=S.device)[:, None]
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    pitches = torch.where(mask, (bin_idx + shift) * float(sr) / n_fft, zero)
    mags = torch.where(mask, S + dskew, zero)
    return pitches, mags, mask


def _tuning_from_piptrack(pitches, mags, pmask, resolution: float = 0.01,
                          bins_per_octave: int = 12) -> torch.Tensor:
    pitch_mask = (pitches > 0) & pmask
    zero = torch.zeros((), dtype=mags.dtype, device=mags.device)
    threshold = torch.where(pitch_mask.any(), masked_quantile(mags, pitch_mask, 0.5), zero)
    sel = (mags >= threshold) & pitch_mask

    # residual of each candidate relative to the nearest bin
    A440 = 440.0
    octs = torch.log2(torch.where(sel, pitches, torch.ones_like(pitches)) / (A440 / 16))
    residual = (bins_per_octave * octs) % 1.0
    residual = torch.where(residual >= 0.5, residual - 1.0, residual)

    # weighted histogram over [-0.5, 0.5] (right-open bins, last bin closed)
    bins = int(np.ceil(1.0 / resolution))
    edges = torch.linspace(-0.5, 0.5, bins + 1, dtype=residual.dtype, device=residual.device)
    r = residual.reshape(-1)
    idx = torch.searchsorted(edges, r, right=True)
    idx = torch.where(r == edges[-1], torch.full_like(idx, bins), idx)
    # slot 0 collects values below the range and slot bins + 1 those above it
    counts = torch.zeros(bins + 2, dtype=torch.float32, device=r.device)
    counts = counts.index_add(0, idx, sel.reshape(-1).to(torch.float32))[1 : bins + 1]
    return edges[torch.argmax(counts)]


def estimate_tuning_device(y: torch.Tensor, sr: int, n_fft: int = 2048, resolution: float = 0.01,
                           bins_per_octave: int = 12) -> torch.Tensor:
    """Tuning deviation in fractional bins as a 0-d device tensor (already on
    the estimator's grid): no host sync; pairs with
    ``spectral.chroma_cqt_device_tuned``."""
    pitches, mags, pmask = piptrack(y, sr, n_fft=n_fft)
    return _tuning_from_piptrack(pitches, mags, pmask, resolution=resolution,
                                 bins_per_octave=bins_per_octave)


def estimate_tuning(y: torch.Tensor, sr: int, n_fft: int = 2048, resolution: float = 0.01,
                    bins_per_octave: int = 12) -> float:
    """Tuning deviation as a host float, rounded to the `resolution` grid."""
    t = float(estimate_tuning_device(y, sr, n_fft, resolution, bins_per_octave))
    return round(t / resolution) * resolution
