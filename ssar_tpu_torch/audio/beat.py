"""Onset strength, Fourier tempogram and predominant local pulse (PLP).

Counterpart of ``ssar_tpu/audio/beat.py``.  The tempogram is an STFT of the
onset envelope at hop 1.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .convert import power_to_db
from .spectral import frame_signal, hann_window, istft, mel_basis, melspectrogram, stft


def _lag(env: torch.Tensor, n_fft: int, hop_length: int, T: int) -> torch.Tensor:
    """Right-shift by 1 + n_fft // (2 hop) frames (STFT framing lag), keep T."""
    return F.pad(env, (1 + n_fft // (2 * hop_length), 0))[..., :T]


def onset_strength(y: torch.Tensor, sr: int, hop_length: int = 1024, n_fft: int = 2048,
                   aggregate: str = "mean") -> torch.Tensor:
    """Spectral-flux onset envelope, (T,): positive time difference of the dB
    mel spectrogram, aggregated over mel bands."""
    S = power_to_db(melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length, fmax=11025.0).abs())
    diff = torch.clamp(S[:, 1:] - S[:, :-1], min=0.0)
    if aggregate == "mean":
        env = diff.mean(dim=0)
    elif aggregate == "median":
        env = _median_lower_upper(diff, dim=0)
    else:
        raise ValueError(aggregate)
    return _lag(env, n_fft, hop_length, S.shape[1])


def _median_lower_upper(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy median (mean of the two middle values for an even count);
    ``torch.median`` returns the lower one."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) / 2).squeeze(dim)


def mel_power_multi(signals: torch.Tensor, sr: int, hop_length: int = 1024,
                    n_fft: int = 2048) -> torch.Tensor:
    """Batched mel power spectrograms (pre-dB): (N, L) -> (N, n_mels, T)."""
    frames = frame_signal(signals, n_fft, hop_length)
    frames = frames * torch.as_tensor(hann_window(n_fft), dtype=frames.dtype, device=frames.device)
    S = torch.fft.rfft(frames, dim=-1).abs() ** 2   # (N, T+1, F)
    S = S[:, :-1]                                    # drop the trailing frame
    basis = torch.as_tensor(mel_basis(sr, n_fft, fmax=11025.0), device=S.device)
    return torch.einsum("mf,ntf->nmt", basis, S)


def onset_env_from_melpower(M: torch.Tensor, hop_length: int = 1024, n_fft: int = 2048,
                            aggregate: str = "mean") -> torch.Tensor:
    """(N, n_mels, T) mel power -> (N, T) onset envelopes (per-signal dB,
    positive flux, band aggregate, lag shift)."""
    log_spec = 10.0 * torch.log10(torch.clamp(M, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 80.0)
    diff = torch.clamp(log_spec[:, :, 1:] - log_spec[:, :, :-1], min=0.0)
    env = diff.mean(dim=1) if aggregate == "mean" else _median_lower_upper(diff, dim=1)
    return _lag(env, n_fft, hop_length, log_spec.shape[2])


def onset_strength_multi(signals: torch.Tensor, sr: int, hop_length: int = 1024, n_fft: int = 2048,
                         aggregate: str = "mean") -> torch.Tensor:
    """Batched onset strength: (N, L) -> (N, T), per signal as onset_strength."""
    M = mel_power_multi(signals, sr, hop_length=hop_length, n_fft=n_fft)
    return onset_env_from_melpower(M, hop_length=hop_length, n_fft=n_fft, aggregate=aggregate)


def fourier_tempo_frequencies(sr: int, win_length: int = 1024, hop_length: int = 1024) -> np.ndarray:
    rate = sr * 60 / float(hop_length)
    return np.linspace(0, float(rate) / 2, int(1 + win_length // 2)).astype(np.float32)


def fourier_tempogram(onset_envelope: torch.Tensor, sr: int = 22050, hop_length: int = 1024,
                      win_length: int = 1024) -> torch.Tensor:
    """STFT of the onset envelope at hop 1, (1 + win//2, T + 1) complex.  `sr`
    and `hop_length` are the envelope's, taken for the reference's signature
    and not used."""
    return stft(onset_envelope, n_fft=win_length, hop_length=1, center=True, window="hann")


def plp(y: torch.Tensor, sr: int, hop_length: int = 1024, win_length: int = 1024,
        tempo_min: float | None = 60, tempo_max: float | None = 180) -> torch.Tensor:
    """Predominant local pulse, normalised to [0, 1], (T,)."""
    onset_env = onset_strength(y, sr, hop_length=hop_length, aggregate="median")
    return plp_from_onset_env(onset_env, sr, hop_length=hop_length, win_length=win_length,
                              tempo_min=tempo_min, tempo_max=tempo_max)


def plp_from_onset_env(onset_env: torch.Tensor, sr: int, hop_length: int = 1024,
                       win_length: int = 1024, tempo_min: float | None = 60,
                       tempo_max: float | None = 180) -> torch.Tensor:
    max_win = min(onset_env.shape[0], win_length)
    ftgram = fourier_tempogram(onset_env, sr=sr, hop_length=hop_length, win_length=max_win)
    freqs = torch.as_tensor(fourier_tempo_frequencies(sr, hop_length=hop_length, win_length=max_win),
                            device=ftgram.device)[:, None]
    zero = torch.zeros((), dtype=ftgram.dtype, device=ftgram.device)
    if tempo_min is not None:
        ftgram = torch.where(freqs < tempo_min, zero, ftgram)
    if tempo_max is not None:
        ftgram = torch.where(freqs > tempo_max, zero, ftgram)

    ftmag = torch.log1p(1e6 * ftgram.abs())
    ftgram = torch.where(ftmag < ftmag.amax(dim=0, keepdim=True), zero, ftgram)
    ftgram = ftgram / (np.finfo(np.float32).tiny ** 0.5 + ftgram.abs().amax(dim=0, keepdim=True))

    pulse = istft(ftgram, n_fft=max_win, hop_length=1, length=onset_env.shape[0])
    pulse = torch.clamp(pulse, min=0.0)   # the upper clip at max(pulse) is a no-op
    pulse = pulse - pulse.min()
    return pulse / (pulse.max() + 1e-8)
