"""Constant-Q / variable-Q transform.

Counterpart of ``ssar_tpu/audio/constantq.py``, both methods:
- ``"recursive"`` (what ``audio2features`` asks for): per octave, one STFT and
  one dense complex product with the FFT-domain filter basis, then a
  kaiser-sinc 2x decimation for the next octave down;
- ``"direct"`` (the default of ``cqt`` / ``vqt``): octaves in groups whose
  shared filter length fits 8192 samples; each group is one real product of
  the framed signal with the time-domain image of the sparsified basis, and
  one decimation by 2^g between groups.
The filter bases are built once per (sr, fmin, bins) on the host in numpy,
sparsified as the reference does, and uploaded as constants.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.resample import resample
from .convert import C1_HZ
from .spectral import frame_signal, stft


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / n))


def constant_q_lengths(sr: float, fmin: float, n_bins: int, bins_per_octave: int,
                       filter_scale: float = 1.0, gamma: float = 0.0) -> np.ndarray:
    alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
    Q = float(filter_scale) / alpha
    freq = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    return Q * sr / (freq + gamma / alpha)


def _constant_q_basis(sr: float, fmin: float, n_bins: int, bins_per_octave: int,
                      filter_scale: float = 1.0, gamma: float = 0.0):
    """Time-domain CQ filters: hann-windowed complex exponentials, L1-normed,
    centre-padded to the next power of two."""
    lengths = constant_q_lengths(sr, fmin, n_bins, bins_per_octave, filter_scale, gamma)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    max_len = int(2.0 ** np.ceil(np.log2(np.max(lengths))))
    filters = np.zeros((n_bins, max_len), dtype=np.complex128)
    for k, (ilen, freq) in enumerate(zip(lengths, freqs)):
        ilen2 = int(ilen // 2)
        n = np.arange(-ilen2, ilen2)
        sig = np.exp(1j * 2 * np.pi * freq / sr * n) * _hann_periodic(len(n))
        sig = sig / np.sum(np.abs(sig))
        lpad = (max_len - len(sig)) // 2
        filters[k, lpad : lpad + len(sig)] = sig
    return filters, lengths


def _sparsify_rows(x: np.ndarray, quantile: float) -> np.ndarray:
    """Zero the basis entries below each row's cumulative-magnitude threshold."""
    if quantile <= 0:
        return x
    mags = np.abs(x)
    norms = np.sum(mags, axis=1, keepdims=True)
    mag_sort = np.sort(mags, axis=1)
    cumulative = np.cumsum(mag_sort / norms, axis=1)
    out = np.zeros_like(x)
    for i in range(x.shape[0]):
        j = int(np.argmin(cumulative[i] < quantile))  # first index at/above the quantile
        keep = mags[i] >= mag_sort[i, j]
        out[i, keep] = x[i, keep]
    return out


@lru_cache(maxsize=32)
def _cqt_filter_fft(sr: float, fmin: float, n_bins: int, bins_per_octave: int,
                    filter_scale: float = 1.0, gamma: float = 0.0, sparsity: float = 0.01):
    """FFT-domain basis (n_bins, n_fft//2 + 1) complex64, and n_fft."""
    basis, lengths = _constant_q_basis(sr, fmin, n_bins, bins_per_octave, filter_scale, gamma)
    n_fft = basis.shape[1]
    basis = basis * (lengths[:, None] / float(n_fft))
    fft_basis = np.fft.fft(basis, n=n_fft, axis=1)[:, : n_fft // 2 + 1]
    fft_basis = _sparsify_rows(fft_basis, sparsity)
    return fft_basis.astype(np.complex64), n_fft


def _num_two_factors(x: int) -> int:
    n = 0
    while x > 0 and x % 2 == 0:
        n += 1
        x //= 2
    return n


@lru_cache(maxsize=32)
def _td_filter_bank(sr: float, fmin: float, n_bins: int, bins_per_octave: int,
                    filter_scale: float = 1.0, gamma: float = 0.0, sparsity: float = 0.01):
    """Time-domain image of the sparsified one-sided FFT basis as one real
    matrix ``[Re(w); Im(w)]``, (2 n_bins, n_fft), with
    ``w[k, n] = sum_f fft_basis[k, f] exp(-2 pi i f n / N)``, so that
    ``frames @ w.T == fft_basis @ rfft(frames).T``: the same sum, reassociated."""
    fft_basis, n_fft = _cqt_filter_fft(sr, fmin, n_bins, bins_per_octave, filter_scale, gamma, sparsity)
    full = np.zeros((fft_basis.shape[0], n_fft), np.complex128)
    full[:, : fft_basis.shape[1]] = fft_basis
    w = np.fft.fft(full, axis=1)
    return np.concatenate([w.real, w.imag], axis=0).astype(np.float32), n_fft


def cqt(y: torch.Tensor, sr: int, hop_length: int = 1024, fmin: float | None = None,
        n_bins: int = 84, bins_per_octave: int = 12, tuning: float | None = 0.0,
        filter_scale: float = 1.0, method: str = "direct") -> torch.Tensor:
    return vqt(y, sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins, gamma=0.0,
               bins_per_octave=bins_per_octave, tuning=tuning, filter_scale=filter_scale, method=method)


def _stack_responses(responses: list, sr: float, fmin: float, n_bins: int, bins_per_octave: int,
                     filter_scale: float, gamma: float) -> torch.Tensor:
    """Trim the per-octave (or per-group) responses, top first, to n_bins rows
    and a common length, stack them bottom first and scale by 1/sqrt(length)."""
    max_col = min(r.shape[-1] for r in responses)
    rows = []
    end = n_bins
    for r in responses:
        n_r = r.shape[0]
        rows.append(r[-min(end, n_r):, :max_col])
        end -= n_r
    V = torch.cat(rows[::-1], dim=0)
    lengths = constant_q_lengths(sr, fmin, n_bins, bins_per_octave, filter_scale, gamma)
    return V / torch.sqrt(torch.as_tensor(lengths[:, None], dtype=V.real.dtype, device=V.device))


def _vqt_direct(y: torch.Tensor, sr: int, hop_length: int, fmin: float, n_bins: int,
                bins_per_octave: int, filter_scale: float, gamma: float, max_fft: int = 8192) -> torch.Tensor:
    """Grouped-octave VQT: for a 7-octave CQT at 36 bins an octave this is two
    framed products and one decimation instead of seven STFTs and six."""
    n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    top_base = float(np.min(freqs[-bins_per_octave:]))  # lowest frequency of the top octave

    # octaves per group: the longest filter of a g-octave group must fit max_fft
    alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
    Q = float(filter_scale) / alpha
    g = 1
    while g < n_octaves:
        longest = Q * sr / ((top_base * 2.0 ** -g) + (gamma / alpha if gamma else 0.0))
        if 2 ** int(np.ceil(np.log2(longest))) > max_fft:
            break
        g += 1

    responses = []
    my_y, my_sr, my_hop = y, float(sr), hop_length
    bins_done = shift = 0
    while bins_done < n_bins:
        n_grp = min(g, n_octaves - shift)
        grp_bins = min(n_grp * bins_per_octave, n_bins - bins_done)
        grp_fmin = top_base * 2.0 ** -(shift + n_grp - 1)
        wri, n_fft = _td_filter_bank(my_sr, grp_fmin, grp_bins, bins_per_octave, filter_scale, gamma)
        frames = frame_signal(my_y, n_fft, my_hop)[:-1]
        resp = torch.as_tensor(wri * np.sqrt(2**shift), dtype=frames.dtype, device=y.device) @ frames.T
        responses.append(torch.complex(resp[:grp_bins], resp[grp_bins:]))
        bins_done += grp_bins
        shift += n_grp
        if bins_done < n_bins:
            factor = 2**n_grp
            my_y = resample(my_y, factor, 1, lowpass_filter_width=6) * np.sqrt(factor)
            my_sr /= factor
            my_hop //= factor
    return _stack_responses(responses, sr, fmin, n_bins, bins_per_octave, filter_scale, gamma)


def vqt(y: torch.Tensor, sr: int, hop_length: int = 1024, fmin: float | None = None,
        n_bins: int = 84, gamma: float | None = None, bins_per_octave: int = 12,
        tuning: float | None = 0.0, filter_scale: float = 1.0, method: str = "direct") -> torch.Tensor:
    """Complex VQT, (n_bins, T), T = len(y) // hop_length.

    `tuning` is a host float; ``None`` estimates it from the signal (one
    device-to-host copy).  `method` is ``"direct"`` (grouped octaves) or
    ``"recursive"`` (the octave-halving chain); the two agree to resampling
    error.
    """
    if method not in ("direct", "recursive"):
        raise ValueError(f"method must be 'direct' or 'recursive', got {method!r}")
    n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))
    n_filters = min(bins_per_octave, n_bins)
    alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
    if fmin is None:
        fmin = C1_HZ
    if tuning is None:
        from .pitch import estimate_tuning

        tuning = estimate_tuning(y, sr, bins_per_octave=bins_per_octave)
    if gamma is None:
        gamma = 24.7 * alpha / 0.108

    fmin = fmin * 2.0 ** (tuning / bins_per_octave)
    if method == "direct":
        return _vqt_direct(y, sr, hop_length, float(fmin), n_bins, bins_per_octave, filter_scale, float(gamma))
    if _num_two_factors(hop_length) < n_octaves - 1:
        raise ValueError(f"hop_length must be a multiple of 2^{n_octaves - 1} for a {n_octaves}-octave CQT/VQT")
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    fmin_t = float(np.min(freqs[-bins_per_octave:]))

    responses = []
    my_y, my_sr, my_hop = y, float(sr), hop_length
    for i in range(n_octaves):
        if i > 0:
            my_y = resample(my_y, 2, 1, lowpass_filter_width=6) * np.sqrt(2)
            my_sr /= 2.0
            my_hop //= 2
        fft_basis, n_fft = _cqt_filter_fft(my_sr, fmin_t * 2.0**-i, n_filters, bins_per_octave,
                                           filter_scale, gamma)
        basis = torch.as_tensor(fft_basis * np.sqrt(2**i), dtype=torch.complex64, device=y.device)
        D = stft(my_y, n_fft=n_fft, hop_length=my_hop, window=None)[:, :-1]
        responses.append(basis @ D)
    return _stack_responses(responses, sr, fmin, n_bins, bins_per_octave, filter_scale, gamma)
