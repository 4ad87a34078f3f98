"""STFT / mel / HPSS / CENS chroma — the spectral core.

Counterpart of ``ssar_tpu/audio/spectral.py``.  Framing is a strided view
(``Tensor.unfold``), never an element gather; window and filterbanks are
host-built numpy constants applied as dense float32 products.  HPSS's two
31-tap medians go through ``ops.median.median_filter`` (the CUDA kernel on
the card).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy.interpolate import CubicSpline

from ..ops.median import median_filter
from .convert import cq_to_chroma_matrix, hz_to_mel_np, mel_to_hz_np

_TINY = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------- windows --
@lru_cache(maxsize=None)
def hann_window(n: int) -> np.ndarray:
    """Periodic hann (torch.hann_window default)."""
    return (0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / n))).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype or like.dtype, device=like.device)


# ------------------------------------------------------------------- stft --
def reflect_pad(y: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """numpy-'reflect' pad of the last axis (edge not repeated).  Pads of at
    least the signal length keep reflecting, as ``np.pad`` does."""
    L = y.shape[-1]
    if left < L and right < L:
        shape = y.shape
        return F.pad(y.reshape(-1, 1, L), (left, right), mode="reflect").reshape(*shape[:-1], -1)
    period = 2 * (L - 1)
    idx = torch.arange(-left, L + right, device=y.device) % period
    idx = torch.where(idx >= L, period - idx, idx)
    return y.index_select(-1, idx)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int, center: bool = True) -> torch.Tensor:
    """(..., L) -> (..., n_frames, n_fft) strided frames; torch.stft center
    semantics (reflect pad by n_fft // 2)."""
    if center:
        y = reflect_pad(y, n_fft // 2, n_fft // 2)
    return y.unfold(-1, n_fft, hop_length)


def stft(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 1024, center: bool = True,
         window: str | None = "hann") -> torch.Tensor:
    """Complex STFT of the last axis, (..., n_fft//2 + 1, n_frames) (torch.stft layout)."""
    frames = frame_signal(y, n_fft, hop_length, center)
    if window is not None:
        frames = frames * _const(hann_window(n_fft), frames)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 1024, center: bool = True,
          window: str | None = "hann", length: int | None = None) -> torch.Tensor:
    """Inverse STFT: windowed overlap-add (``F.fold``) with window-square
    normalisation.  (F, T) -> (L,)."""
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=1)  # (T, n_fft)
    win = _const(hann_window(n_fft), frames) if window is not None else torch.ones_like(frames[0])
    frames = frames * win
    n_frames = frames.shape[0]
    out_len = (n_frames - 1) * hop_length + n_fft

    def overlap_add(cols):  # (T, n_fft) -> (out_len,)
        return F.fold(cols.T[None], output_size=(1, out_len), kernel_size=(1, n_fft),
                      stride=(1, hop_length)).reshape(-1)

    y = overlap_add(frames)
    env = overlap_add((win**2).expand(n_frames, n_fft))
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    if center:
        y = y[n_fft // 2:]
        if length is not None:
            y = y[:length] if y.shape[0] >= length else F.pad(y, (0, length - y.shape[0]))
        else:
            y = y[: out_len - n_fft]
    return y


def spectrogram(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 1024, power: float = 1,
                window: str | None = "hann", center: bool = True) -> torch.Tensor:
    """|STFT|^power without the trailing frame: exactly L // hop frames, so one
    hop is one video frame."""
    S = stft(y, n_fft=n_fft, hop_length=hop_length, center=center, window=window)[..., :-1]
    return S.abs() ** power


# -------------------------------------------------------------------- mel --
@lru_cache(maxsize=None)
def mel_basis(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney mel filterbank (n_mels, 1 + n_fft//2), host-built."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = np.linspace(0, float(sr) / 2, int(1 + n_fft // 2))
    mels = np.linspace(hz_to_mel_np(fmin), hz_to_mel_np(fmax), n_mels + 2)
    mel_f = mel_to_hz_np(mels)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def melspectrogram(y: torch.Tensor, sr: int, n_fft: int = 2048, hop_length: int = 1024,
                   power: float = 2.0, fmax: float | None = None) -> torch.Tensor:
    S = spectrogram(y, n_fft=n_fft, hop_length=hop_length, power=power)
    return _const(mel_basis(sr, n_fft, fmax=fmax), S) @ S


# ------------------------------------------------------------------- hpss --
def magphase(D: torch.Tensor, power: float = 1.0):
    return D.abs() ** power, torch.polar(torch.ones_like(D.real), torch.angle(D))


def softmask(X: torch.Tensor, X_ref: torch.Tensor, power: float = 2.0, split_zeros: bool = False) -> torch.Tensor:
    """Soft mask of X against X_ref."""
    Z = torch.maximum(X, X_ref)
    bad = Z < _TINY
    one = torch.ones_like(Z)
    Zs = torch.where(bad, one, Z)
    mask = (X / Zs) ** power
    ref_mask = (X_ref / Zs) ** power
    mask = mask / torch.where(bad, one, mask + ref_mask)
    return torch.where(bad, torch.full_like(Z, 0.5 if split_zeros else 0.0), mask)


def hpss(S: torch.Tensor, ks: int = 31, power: float = 2.0, margin: float = 1.0):
    """Median-filtering harmonic/percussive separation of a (F, T) STFT:
    harmonic = median over time, percussive = median over frequency."""
    if S.is_complex():
        S, phase = magphase(S)
    else:
        phase = 1.0
    harm = median_filter(S, ks, axis=-1)
    perc = median_filter(S, ks, axis=-2)
    split_zeros = margin == 1
    mask_harm = softmask(harm, perc * margin, power=power, split_zeros=split_zeros)
    mask_perc = softmask(perc, harm * margin, power=power, split_zeros=split_zeros)
    return (S * mask_harm) * phase, (S * mask_perc) * phase


# -------------------------------------------------- CENS spline quantizer --
Q_STEP = 0.25
_QUANT_ALPHA = 20.0


@lru_cache(maxsize=None)
def _quant_spline():
    """Natural cubic spline through librosa's CENS step quantizer knots
    (steps [0.4, 0.2, 0.1, 0.05] onto a smooth ramp 0.5 -> 4.5)."""
    p1, p2, p3, p4 = np.diff(list(reversed([0.4, 0.2, 0.1, 0.05] + [0])))
    xs = [
        np.linspace(-0.1, 0.025, 101)[:-1],
        np.linspace(0.025, p1, 11)[:-1],
        np.linspace(p1, p1 + p2, 11)[:-1],
        np.linspace(p1 + p2, p1 + p2 + p3, 11)[:-1],
        np.linspace(p1 + p2 + p3, 0.5, 11)[:-1],
        np.linspace(0.5, 1.1, 100),
    ]
    ys = np.concatenate([
        0.5 * np.ones(len(xs[0])),
        xs[1] / p1,
        (xs[2] - p1) / p2 + 1,
        (xs[3] - p1 - p2) / p3 + 2,
        (xs[4] - p1 - p2 - p3) / p4 + 3,
        4.5 * np.ones(len(xs[5])),
    ])
    xs = np.concatenate(xs)
    cs = CubicSpline(xs, ys, bc_type="natural")
    return xs.astype(np.float32), cs.c.astype(np.float32)  # c: (4, n-1), cubic first


def spline_eval(t: torch.Tensor) -> torch.Tensor:
    xs_np, c_np = _quant_spline()
    xs, c = _const(xs_np, t), _const(c_np, t)
    idx = torch.clamp(torch.searchsorted(xs, t.contiguous(), right=True) - 1, 0, len(xs_np) - 2)
    f = t - xs[idx]
    return ((c[0, idx] * f + c[1, idx]) * f + c[2, idx]) * f + c[3, idx]


def step_function(w: torch.Tensor, h: float = Q_STEP, alpha: float = _QUANT_ALPHA) -> torch.Tensor:
    """Smooth staircase."""
    r = (w - 0.5) - torch.floor(w - 0.5) - 0.5
    m = 1.0 / (1.0 + np.exp(-alpha)) - 0.5
    return h * (torch.floor(w - 0.5) + 1.0 / (2 * m) * 1.0 / (1.0 + torch.exp(-2 * alpha * r)))


def spline_quantize(chroma: torch.Tensor) -> torch.Tensor:
    return step_function(spline_eval(chroma))


# ----------------------------------------------------------------- chroma --
def chroma_cqt(y: torch.Tensor, sr: int, hop_length: int = 1024, fmin: float | None = None,
               threshold: float | None = 0.0, tuning: float | None = None, n_chroma: int = 12,
               n_octaves: int = 7, bins_per_octave: int = 36, norm: bool = True,
               method: str = "recursive") -> torch.Tensor:
    """CQT -> chroma fold, (12, T).  `tuning` is a host float."""
    from .constantq import cqt

    C = cqt(y, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_octaves * bins_per_octave,
            bins_per_octave=bins_per_octave, tuning=tuning, method=method).abs()
    fold = _const(cq_to_chroma_matrix(C.shape[0], bins_per_octave=bins_per_octave,
                                      n_chroma=n_chroma, fmin=fmin), C)
    return _threshold_norm(fold @ C, threshold, norm)


def _threshold_norm(chroma, threshold, norm):
    if threshold is not None:
        chroma = torch.where(chroma < threshold, torch.zeros_like(chroma), chroma)
    if norm:
        chroma = chroma / (chroma.max() + 1e-20)
    return chroma


def chroma_cqt_device_tuned(y: torch.Tensor, sr: int, tuning: torch.Tensor, hop_length: int = 1024,
                            fmin: float | None = None, n_chroma: int = 12, n_octaves: int = 7,
                            bins_per_octave: int = 36, threshold: float | None = 0.0,
                            norm: bool = True, method: str = "recursive") -> torch.Tensor:
    """chroma_cqt with the tuning correction applied on the device: the CQT
    runs once on a half-bin grid (2x bins_per_octave) and the tuned bins are
    interpolated from their two fine neighbours, so `tuning` stays a device
    scalar and no host sync is needed."""
    from .constantq import cqt
    from .convert import C1_HZ

    if fmin is None:
        fmin = C1_HZ
    n_bins = n_octaves * bins_per_octave
    fine_bpo = 2 * bins_per_octave
    n_fine = 2 * n_bins + 2  # one fine-bin guard on each side
    fmin_fine = fmin * 2.0 ** (-1.0 / fine_bpo)
    C_fine = cqt(y, sr=sr, hop_length=hop_length, fmin=fmin_fine, n_bins=n_fine,
                 bins_per_octave=fine_bpo, tuning=0.0, method=method).abs()

    # coarse bin k at tuning tau sits at fine index 2k + 1 + 2*tau
    idx = 2.0 * torch.arange(n_bins, device=y.device, dtype=C_fine.dtype) + 1.0 + 2.0 * tuning.to(C_fine.dtype)
    lo = torch.clamp(torch.floor(idx).long(), 0, n_fine - 2)
    frac = (idx - lo)[:, None]
    C = C_fine[lo] * (1 - frac) + C_fine[lo + 1] * frac

    fold = _const(cq_to_chroma_matrix(n_bins, bins_per_octave=bins_per_octave,
                                      n_chroma=n_chroma, fmin=fmin), C)
    return _threshold_norm(fold @ C, threshold, norm)


def chroma_cens(y: torch.Tensor, sr: int, hop_length: int = 1024, fmin: float | None = None,
                tuning=None, n_chroma: int = 12, n_octaves: int = 7,
                bins_per_octave: int = 36, win_len_smooth: int = 41,
                method: str = "recursive") -> torch.Tensor:
    """Chroma energy-normalised statistics, (12, T).  `tuning` is a host float
    (static basis) or a 0-d tensor (device-interpolated fine-grid path)."""
    if isinstance(tuning, torch.Tensor):
        chroma = chroma_cqt_device_tuned(y, sr, tuning, hop_length=hop_length, fmin=fmin,
                                         n_chroma=n_chroma, n_octaves=n_octaves,
                                         bins_per_octave=bins_per_octave, norm=False, method=method)
    else:
        chroma = chroma_cqt(y, sr, hop_length=hop_length, fmin=fmin, bins_per_octave=bins_per_octave,
                            tuning=tuning, n_chroma=n_chroma, n_octaves=n_octaves, norm=False,
                            method=method)
    # eps guard: silent frames stay finite rather than 0/0
    chroma = chroma / (chroma.abs().sum(dim=0) + 1e-20)
    chroma_quant = spline_quantize(chroma)

    if win_len_smooth:
        win = hann_window(win_len_smooth + 2).astype(np.float32)
        win = win / win.sum()
        pad = (win_len_smooth + 2) // 2
        cq = F.pad(chroma_quant, (pad, pad - 1 + (win_len_smooth + 2) % 2))
        cens = F.conv1d(cq[:, None, :], _const(win, cq)[None, None, :])[:, 0, :]
    else:
        cens = chroma_quant
    return cens / (torch.linalg.vector_norm(cens, ord=2, dim=0) + 1e-20)
