"""Additional MIR features: spectral peaks, HPCP, the full raw HPCP pipeline,
tempogram ratio.

Counterpart of ``ssar_tpu/audio/extra.py``: the madmom / essentia-style
features of the preliminary analysis study.  Each runs where its input
lies.  ``raw_hpcp``'s pitch profile scatters the peak magnitudes into their
constant-Q bins with ``scatter_add_`` where the JAX package multiplies by a
dense (F, T, 132) one-hot (3.1 GB for a 60 s track): the same sums, added
in another order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import full_precision
from .beat import onset_strength
from .spectral import spectrogram


def spectral_peaks(S: torch.Tensor, sr: int, n_fft: int = 2048, threshold_db: float = -60.0):
    """Local-maximum peak mask with parabolically interpolated frequencies.

    S (F, T) magnitude; returns (freqs (F, T), mags (F, T), mask (F, T)).
    """
    mag_db = 20.0 * torch.log10(torch.clamp(S, min=1e-10))
    above = mag_db > (mag_db.max() + threshold_db)

    Sp = F.pad(S, (0, 0, 1, 1))
    localmax = (S > Sp[:-2]) & (S >= Sp[2:])

    num = 0.5 * (Sp[:-2] - Sp[2:])
    den = Sp[:-2] - 2 * S + Sp[2:]
    ok = den.abs() > 1e-12
    shift = torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(den))

    bins = torch.arange(S.shape[0], dtype=S.dtype, device=S.device)[:, None]
    freqs = (bins + shift) * sr / n_fft
    return freqs, S, localmax & above


def hpcp(y: torch.Tensor, sr: int, n_bins: int = 12, f_ref: float = 440.0,
         n_harmonics: int = 4, fmin: float = 100.0, fmax: float = 5000.0) -> torch.Tensor:
    """Harmonic pitch-class profile, (T, n_bins), max-normalised per frame:
    each spectral peak adds cos^2-weighted energy to the pitch classes of its
    first `n_harmonics` subharmonics.  (The pitch-class distance is a floor
    modulo, ``torch.remainder``, as ``jnp``'s ``%``.)"""
    S = spectrogram(y, power=1.0)
    freqs, mags, mask = spectral_peaks(S, sr)

    valid = mask & (freqs > fmin) & (freqs < fmax)
    w = torch.where(valid, mags**2, torch.zeros_like(mags))

    out = torch.zeros((n_bins, S.shape[1]), dtype=S.dtype, device=S.device)
    window_size = 4.0 / 3.0  # semitones
    half_width = window_size / 2 * (n_bins / 12)
    b = torch.arange(n_bins, dtype=S.dtype, device=S.device)[:, None, None]
    for h in range(1, n_harmonics + 1):
        pc = torch.remainder(n_bins * torch.log2(torch.clamp(freqs / h, min=1e-6) / f_ref), n_bins)
        contrib = w * (0.8 ** (h - 1))
        d = (torch.remainder(pc[None] - b + n_bins / 2, n_bins) - n_bins / 2).abs()   # (n_bins, F, T)
        weight = torch.where(d <= half_width, torch.cos(np.pi / 2 * d / (window_size * (n_bins / 12))) ** 2,
                             torch.zeros_like(d))
        out = out + (contrib[None] * weight).sum(dim=1)
    return (out / (out.amax(dim=0, keepdim=True) + 1e-12)).T


def _harmonic_kernel(bins_per_octave: int, harmonic_tolerance: float, harmonic_decay: float) -> np.ndarray:
    """The decay-weighted cos^2 harmonic-summation kernel over +-4 octaves of
    log-frequency bins (float32)."""
    n_oct = 4
    r = np.arange(-n_oct * bins_per_octave, n_oct * bins_per_octave + 1) / bins_per_octave
    f_ratio = 2.0**r
    n_harm = np.round(f_ratio)
    d_harm = np.abs(f_ratio - n_harm)
    width = np.log(2.0 ** (harmonic_tolerance / 12.0))
    w = np.where(d_harm < width, np.cos(d_harm * (np.pi / 2) / width) ** 2, 0.0)
    w = w * np.where(n_harm > 0, harmonic_decay ** np.maximum(n_harm - 1, 0), 0.0)
    return (w / w.sum()).astype(np.float32)


def _conv_rows(pp: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Cross-correlate each row of (T, P) with `kernel` (L,), zero padding
    (L - 1) // 2 before and L // 2 after: the output keeps P."""
    L = kernel.shape[0]
    x = F.pad(pp[:, None, :], ((L - 1) // 2, L // 2))
    with full_precision():
        return F.conv1d(x, kernel.view(1, 1, L))[:, 0]


def raw_hpcp(y: torch.Tensor, sr: int, win_size: int = 4096, hop_size: int = 512,
             f_min: float = 100.0, f_max: float = 5000.0, global_thr: float = 80.0,
             local_thr: float = 30.0, bins_per_octave: int = 12,
             whitening: bool = True, filter_width: float = 1 / 3.0,
             harmonic_decay: float = 0.6, harmonic_tolerance: float = 2 / 3.0,
             norm_frames: bool = False, final_thr: float = 0.0) -> torch.Tensor:
    """The full HPCP pipeline, (T, bins_per_octave): dB thresholds (global,
    then per frame), parabolic peak interpolation, a multi-octave pitch
    profile (peaks rounded to the nearest constant-Q bin), spectral
    whitening, harmonic summation, octave folding at every C."""
    S = spectrogram(y, n_fft=win_size, hop_length=hop_size, power=1.0)  # (F, T)
    n_f = S.shape[0]
    freqs_bin = torch.arange(n_f, dtype=torch.float32, device=S.device) * sr / win_size
    band = ((freqs_bin > f_min) & (freqs_bin < f_max))[:, None]

    Y_dB = 20.0 * torch.log10(torch.clamp(S, min=1e-10))
    Y_dB = torch.where(band, Y_dB, torch.full_like(Y_dB, -torch.inf))
    X = torch.clamp(Y_dB - Y_dB.max() + global_thr, min=0.0)
    if local_thr < global_thr:
        X = torch.where(X < X.amax(dim=0, keepdim=True) - local_thr, torch.zeros_like(X), X)

    Xp = F.pad(X, (0, 0, 1, 1))
    a1, a2, a3 = Xp[:-2], X, Xp[2:]
    peaks = (a2 > a1) & (a2 > a3) & band
    den = a1 - 2 * a2 + a3
    ok = den.abs() > 1e-12
    zero = torch.zeros_like(X)
    d = torch.where(peaks & ok, 0.5 * (a1 - a3) / torch.where(ok, den, torch.ones_like(den)), zero)
    freqs = (torch.arange(n_f, dtype=torch.float32, device=S.device)[:, None] + d) * sr / win_size
    A_dB = torch.where(peaks, a2 - d / 4 * (a1 - a3), zero)
    A_lin = torch.where(peaks, 10.0 ** ((A_dB - global_thr) / 20.0), zero)

    midi = torch.where(freqs > 0, 69.0 + 12.0 * torch.log2(torch.clamp(freqs, min=1e-6) / 440.0), zero)
    n_pp = bins_per_octave * 11  # MIDI 0..131, 11 octaves
    pp_bin = torch.clamp(torch.round(bins_per_octave * midi / 12.0).to(torch.int64), 0, n_pp - 1)
    pp = torch.zeros((S.shape[1], n_pp), dtype=X.dtype, device=S.device)
    pp.scatter_add_(1, pp_bin.T, A_lin.T)  # (T, n_pp)

    if whitening:  # subtract a moving average over filter_width octaves
        k = max(int(bins_per_octave * filter_width), 1)
        pp = torch.clamp(pp - _conv_rows(pp, torch.full((k,), 1.0 / k, device=S.device)), min=0.0)

    kernel = torch.as_tensor(_harmonic_kernel(bins_per_octave, harmonic_tolerance, harmonic_decay), device=S.device)
    pcp = _conv_rows(pp, kernel).reshape(-1, 11, bins_per_octave).sum(dim=1)

    if norm_frames:
        pcp = pcp - pcp.amin(dim=1, keepdim=True)
        mx = pcp.amax(dim=1, keepdim=True)
        pcp = torch.where(mx > 0, pcp / torch.clamp(mx, min=1e-12), pcp)
        if final_thr > 0:
            pcp = (1 - final_thr) * (pcp - final_thr) * (pcp > final_thr)
    return pcp


TEMPO_RATIOS = np.asarray([0.25, 1 / 3, 0.5, 2 / 3, 1.0, 1.5, 2.0, 3.0], np.float32)


def tempogram_ratio(y: torch.Tensor, sr: int, bpm: float, n_ratios: int = 8) -> torch.Tensor:
    """The autocorrelation tempogram's energy at rational multiples of the
    global tempo, (n_ratios,).  The lags are rounded on the host in float32,
    as the JAX package rounds them."""
    env = onset_strength(y, sr)
    env = env - env.mean()
    n = env.shape[0]
    f = torch.fft.rfft(env, n=2 * n)
    ac = torch.fft.irfft(f * f.conj())[:n]
    ac = torch.clamp(ac, min=0.0) / (ac[0] + 1e-12)

    period = np.float32(60.0 * sr / (1024.0 * bpm))
    lags = np.clip(np.round(period * TEMPO_RATIOS[:n_ratios]).astype(np.int64), 0, n - 1)
    return ac[torch.as_tensor(lags, device=ac.device)]
