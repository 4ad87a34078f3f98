"""Named audio features and the canonical 59-dim ``audio2features`` stack.

Counterpart of ``ssar_tpu/audio/features.py``.  Functions take a mono
waveform at ``sr = 1024 * fps`` and return frame-rate features with
``T = len(audio) // 1024`` rows.  ``audio2features`` is the entry point: it
resamples, runs the stack on the CUDA device (or the CPU when asked) with
TF32 off, and never copies to the host on the way.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.dct import dct
from ..ops.quantile import clamp_lower_percentile, clamp_peaks_percentile
from ..ops.resample import resample
from ..utils.device import full_precision, resolve_device
from .beat import onset_strength, onset_strength_multi, plp
from .convert import power_to_db
from .pitch import estimate_tuning_device
from .processing import emphasize, gaussian_filter, high_pass, low_pass, normalize
from .spectral import chroma_cens, frame_signal, hpss, istft, melspectrogram, spectrogram, stft

FEATURE_NAMES = [
    *[f"mfcc_{i}" for i in range(20)],
    *[f"chroma_{i}" for i in range(12)],
    *[f"tonnetz_{i}" for i in range(6)],
    *[f"contrast_{i}" for i in range(7)],
    "flatness", "onsets", "onsets_low", "onsets_mid", "onsets_high", "pulse",
    "harmonic_rms", "harmonic_rms_low", "harmonic_rms_mid", "harmonic_rms_high",
    "long_rms", "long_rms_low", "long_rms_mid", "long_rms_high",
]
N_FEATURES = len(FEATURE_NAMES)  # 59

# Per-group absolute-deviation budgets of the stack against a reference run
# (docs/PARITY.md): column slices of the (T, 59) output and their budget.
PARITY_BUDGETS = {
    "mfcc": (slice(0, 20), 1e-2), "chroma": (slice(20, 32), 1e-3), "tonnetz": (slice(32, 38), 1e-3),
    "contrast": (slice(38, 45), 1e-2), "flatness": (slice(45, 46), 1e-4), "onsets": (slice(46, 50), 1e-2),
    "pulse": (slice(50, 51), 1e-3), "rms": (slice(51, 55), 1e-4), "drop_strength": (slice(55, 59), 1e-3),
}


# ------------------------------------------------------------ components --
def harmonic_percussive(audio: torch.Tensor, margin: float = 8.0):
    """Harmonic and percussive components back in the time domain, from one
    shared STFT (two median filters)."""
    H, P = hpss(stft(audio), margin=margin)
    return istft(H, length=audio.shape[0]), istft(P, length=audio.shape[0])


def harmonic(audio: torch.Tensor, margin: float = 8.0) -> torch.Tensor:
    """HPSS harmonic component back in the time domain."""
    return harmonic_percussive(audio, margin)[0]


def percussive(audio: torch.Tensor, margin: float = 8.0) -> torch.Tensor:
    """HPSS percussive component back in the time domain."""
    return harmonic_percussive(audio, margin)[1]


def onsets(audio: torch.Tensor, sr: int) -> torch.Tensor:
    """Normalised onset envelope of the percussive component, (T, 1)."""
    return normalize(onset_strength(percussive(audio), sr))[:, None]


def rms(y: torch.Tensor, sr: int, frame_length: int = 2048, hop_length: int = 1024,
        center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """Framewise root-mean-square, (T, 1)."""
    if pad_mode != "reflect":
        raise ValueError(f"rms supports pad_mode='reflect' only, got {pad_mode!r}")
    frames = frame_signal(y, frame_length, hop_length, center=center)[:-1]
    return torch.sqrt((frames.abs() ** 2).mean(dim=1))[:, None]


def drop_strength(audio: torch.Tensor, sr: int) -> torch.Tensor:
    """Long-term RMS with tanh emphasis, (T, 1)."""
    return emphasize(gaussian_filter(rms(audio, sr), 10), strength=10, percentile=50)[:, None]


def chromagram(audio: torch.Tensor, sr: int, tuning: float | torch.Tensor | None = None,
               method: str = "recursive") -> torch.Tensor:
    """CENS chroma of the re-separated harmonic audio, (T, 12).  `tuning` is a
    host float, a 0-d device tensor (interpolated CQT basis) or ``None``: the
    deviation is then estimated on the device from the harmonic signal.
    `method` is the CQT's (``"recursive"`` or ``"direct"``)."""
    h = harmonic(audio)
    if tuning is None:
        tuning = estimate_tuning_device(h, sr)
    return chroma_cens(h, sr, tuning=tuning, method=method).T


def _tonnetz_of_chroma(chroma: torch.Tensor) -> torch.Tensor:
    """Tonal centroid features from a (T, 12) chromagram, (T, 6)."""
    chroma = chroma.T
    n = chroma.shape[0]
    dim_map = np.linspace(0, 12, n, dtype=np.float32)
    scale = np.asarray([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3], np.float32)
    V = scale[:, None] * dim_map[None, :]
    V[::2] -= 0.5
    R = np.asarray([1.0, 1.0, 1.0, 1.0, 0.5, 0.5], np.float32)
    phi = torch.as_tensor(R[:, None] * np.cos(np.pi * V), dtype=chroma.dtype, device=chroma.device)
    return (phi @ (chroma / chroma.abs().sum(dim=0))).T


def tonnetz(y: torch.Tensor | None, sr: int, chroma: torch.Tensor | None = None,
            tuning: float | torch.Tensor | None = None, method: str = "recursive") -> torch.Tensor:
    """Tonal centroid features, (T, 6), of the waveform `y` or of a (T, 12)
    `chroma` computed beforehand."""
    return _tonnetz_of_chroma(chromagram(y, sr, tuning=tuning, method=method) if chroma is None else chroma)


def pulse(audio: torch.Tensor, sr: int) -> torch.Tensor:
    """(T, 1) predominant local pulse of the percussive component."""
    return plp(percussive(audio), sr)[:, None]


def mfcc(y: torch.Tensor, sr: int, n_mfcc: int = 20) -> torch.Tensor:
    """(T, n_mfcc)."""
    S = power_to_db(melspectrogram(y, sr))
    return dct(S.T, norm="ortho").T[:n_mfcc].T


def spectral_contrast(y: torch.Tensor, sr: int, n_fft: int = 2048, hop_length: int = 1024,
                      fmin: float = 200.0, n_bands: int = 6, quantile: float = 0.02,
                      linear: bool = False) -> torch.Tensor:
    """Octave-band spectral valley/peak contrast, (T, n_bands + 1): in dB, or
    the linear peak - valley with ``linear``.  Band memberships depend only on
    (sr, n_fft) and are resolved on the host."""
    S = spectrogram(y, n_fft=n_fft, hop_length=hop_length)
    freq = np.linspace(0, float(sr) / 2, int(1 + n_fft // 2))
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))

    valleys, peaks = [], []
    for k in range(n_bands + 1):
        f_low, f_high = octa[k], octa[k + 1]
        current_band = (freq >= f_low) & (freq <= f_high)
        if not current_band.any():  # band above nyquist (low fps/sr): use the top bin
            current_band[-1] = True
        idx = np.flatnonzero(current_band)
        if k > 0:
            current_band[idx[0] - 1] = True
        if k == n_bands:
            current_band[idx[-1] + 1 :] = True
        band_rows = np.flatnonzero(current_band)
        sub = S[band_rows[0] : band_rows[-1] + 1]
        if k < n_bands:
            sub = sub[:-1]
        n_take = int(max(round(quantile * current_band.sum()), 1))
        srt = torch.sort(sub, dim=0).values
        valleys.append(srt[:n_take].mean(dim=0))
        peaks.append(srt[-n_take:].mean(dim=0))
    peak, valley = torch.stack(peaks), torch.stack(valleys)
    if linear:
        return (peak - valley).T
    return (power_to_db(peak) - power_to_db(valley)).T


def spectral_flatness(y: torch.Tensor, sr: int, n_fft: int = 2048, hop_length: int = 1024,
                      amin: float = 1e-10, power: float = 2.0) -> torch.Tensor:
    """(T, 1).  `sr` is taken for the common ``fn(audio, sr)`` signature and
    not used."""
    S = spectrogram(y, n_fft=n_fft, hop_length=hop_length, power=1.0)
    S_thresh = torch.clamp(S**power, min=amin)
    gmean = torch.exp(torch.log(S_thresh).mean(dim=0))
    return (gmean / S_thresh.mean(dim=0))[:, None]


def rms_multi(signals: torch.Tensor, frame_length: int = 2048, hop_length: int = 1024) -> torch.Tensor:
    """Batched framewise RMS: (N, L) -> (N, T)."""
    frames = frame_signal(signals, frame_length, hop_length)[:, :-1]
    return torch.sqrt((frames**2).mean(dim=2))


# ------------------------------------------------------ the 59-dim stack --
def _post(features: torch.Tensor, fps: int, clamp: bool, smooth: bool, emphasis: bool) -> torch.Tensor:
    if clamp:
        P = 2.5
        features = clamp_peaks_percentile(features, 100 - P)
        features = clamp_lower_percentile(features, 4 * P)
    if smooth:
        features = gaussian_filter(features, 0.1 * fps)
    if emphasis:
        features = emphasize(features, strength=2, percentile=75)
    return features


def features_at_rate(audio: torch.Tensor, sr: int, fps: int, clamp: bool = True, smooth: bool = True,
                     emphasis: bool = False, tuning: float | None = None,
                     velocity: bool = False, cqt_method: str = "recursive") -> torch.Tensor:
    """The (T, 59) stack of a mono waveform already at ``sr = 1024 * fps``,
    on the waveform's device."""
    audio_harm, audio_perc = harmonic_percussive(audio)

    mf = mfcc(audio, sr)
    contrast = spectral_contrast(audio, sr)
    flat = spectral_flatness(audio, sr)

    if tuning is None:
        # tuning stays a device scalar, estimated on exactly 4 s of the
        # harmonic signal (zero-padded or cropped)
        cap = 4 * sr
        seg = F.pad(audio_harm[:cap], (0, max(0, cap - audio_harm.shape[0])))
        tuning = estimate_tuning_device(seg, sr, bins_per_octave=36)
    else:
        tuning = float(tuning)
    chroma = chromagram(audio_harm, sr, tuning, method=cqt_method)
    ton = tonnetz(None, sr, chroma=chroma)

    # band onsets from one batched mel pipeline; mid_pass(x) == low_pass(high_pass(x))
    hp = high_pass(audio_perc, sr)
    envs = onset_strength_multi(torch.stack([audio_perc, low_pass(audio_perc, sr), low_pass(hp, sr), hp]), sr)
    pls = plp(audio_perc, sr)

    # eight band-RMS envelopes from one batched framing
    both = torch.stack([audio_harm, audio])
    hi = high_pass(both, sr)
    bands = torch.stack([both, low_pass(both, sr), low_pass(hi, sr), hi], dim=1).reshape(8, -1)
    band_rms = rms_multi(bands)  # (8, T): harmonic x4, then full audio x4
    drops = [emphasize(gaussian_filter(band_rms[i][:, None], 10), strength=10, percentile=50) for i in range(4, 8)]

    single = [flat, *envs, pls, *band_rms[:4], *drops]
    features = torch.cat([mf, chroma, ton, contrast] + [s.reshape(-1, 1) for s in single], dim=1)
    if velocity:  # optional velocity channels: 59 -> 118 dims
        V = torch.diff(gaussian_filter(features, fps), dim=0)
        features = torch.cat([features, torch.cat([V[:1], V], dim=0)], dim=1)
    return _post(features, fps, clamp, smooth, emphasis)


def audio2features(audio, sr: int, fps: int, clamp: bool = True, smooth: bool = True,
                   emphasis: bool = False, tuning: float | None = None, velocity: bool = False,
                   cqt_method: str = "recursive", device: str | torch.device | None = None) -> torch.Tensor:
    """(T, 59) canonical feature stack of a waveform (numpy or tensor, (L,) mono
    or (C, L)), resampled to ``1024 * fps``.

    Runs on the CUDA device unless ``device`` says otherwise (``"cpu"``);
    raises when no CUDA device is present and none was named.  ``tuning=None``
    estimates the tuning on the device; a float fixes it.  `cqt_method` is the
    chroma's CQT: ``"recursive"`` (the reference stack's) or ``"direct"``.
    """
    device = resolve_device(device)
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device)
    if audio.ndim == 2:
        audio = audio.mean(dim=0)
    target_sr = fps * 1024
    with torch.no_grad(), full_precision():
        if sr != target_sr:
            audio = resample(audio, sr, target_sr, lowpass_filter_width=6)
        return features_at_rate(audio, target_sr, fps, clamp=clamp, smooth=smooth, emphasis=emphasis,
                                tuning=tuning, velocity=velocity, cqt_method=cqt_method)
