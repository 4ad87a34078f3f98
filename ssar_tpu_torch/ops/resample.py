"""Kaiser-windowed sinc resampling as one strided convolution.

Counterpart of ``ssar_tpu/ops/resample.py`` (torchaudio ``resample(...,
resampling_method="kaiser_window")``): the polyphase kernel depends only on
the reduced (orig, new) pair, is built once on the host in float64 and cast
to float32, and the resample is one ``conv1d`` with stride ``orig`` and
``new`` output channels.
"""
from __future__ import annotations

from functools import lru_cache
from math import ceil, gcd

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import i0 as _i0

_KAISER_BETA = 14.769656459379492  # beta for ~80 dB stopband, torchaudio default


@lru_cache(maxsize=None)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 16, rolloff: float = 0.99,
                 beta: float = _KAISER_BETA):
    """Polyphase kaiser-windowed sinc kernel, shape (new_freq, 1, K), plus pad width."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)

    window = _i0(beta * np.sqrt(np.clip(1 - (t / lowpass_filter_width) ** 2, 0, None))) / _i0(beta)
    tpi = t * np.pi
    kernel = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel[:, None, :].astype(np.float32), width


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 16, rolloff: float = 0.99) -> torch.Tensor:
    """Resample along the last axis: (..., L) -> (..., ceil(L * new / orig))."""
    orig_freq, new_freq = int(orig_freq), int(new_freq)
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError(f"sample rates must be positive, got {orig_freq} -> {new_freq}")
    if orig_freq == new_freq:
        return waveform
    g = gcd(orig_freq, new_freq)
    o, n = orig_freq // g, new_freq // g
    kernel_np, width = _sinc_kernel(o, n, lowpass_filter_width, rolloff)
    dtype = torch.promote_types(waveform.dtype, torch.float32)
    kernel = torch.as_tensor(kernel_np, dtype=dtype, device=waveform.device)

    shape = waveform.shape
    L = shape[-1]
    x = F.pad(waveform.reshape(-1, 1, L).to(dtype), (width, width + o))
    y = F.conv1d(x, kernel, stride=o)                      # (B, new, L//o + 1)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)
    target_len = ceil(n * L / o)
    return y[:, :target_len].reshape(*shape[:-1], target_len).to(waveform.dtype)
