# Frozen copy of ssar_tpu_torch/audio/convert.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Unit conversions (Hz / mel / chroma maps) and dB scaling.

Counterpart of ``ssar_tpu/audio/convert.py``.  Filterbank builders are
host-side numpy (built once, uploaded as constants, the ``*_np`` forms);
``power_to_db``, ``hz_to_mel``, ``mel_to_hz`` and ``hz_to_octs`` run on
float32 tensors, on the device of a tensor argument.
"""
from __future__ import annotations

import numpy as np
import torch

# note_to_hz("C1"), the only note the pipeline looks up; A440 equal temperament
C1_HZ = 440.0 * 2.0 ** ((24 - 69) / 12.0)  # 32.70319566257483


def note_to_hz(note: str) -> float:
    """The frequency of ``"C1"``, the one note the pipeline looks up."""
    if note != "C1":
        raise ValueError(f"only C1 is used anywhere in the pipeline, got {note!r}")
    return C1_HZ


def power_to_db(magnitude: torch.Tensor, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0) -> torch.Tensor:
    """10*log10 with floor and a top_db clamp relative to the global max."""
    log_spec = 10.0 * torch.log10(torch.clamp(magnitude, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def hz_to_mel(frequencies, htk: bool = False) -> torch.Tensor:
    """Slaney (default) or HTK mel scale of scalars or tensors, float32."""
    frequencies = torch.as_tensor(frequencies, dtype=torch.float32)
    if htk:
        return 2595.0 * torch.log10(1.0 + frequencies / 700.0)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = float(np.log(6.4) / 27.0)
    log_mels = min_log_mel + torch.log(torch.clamp(frequencies, min=1e-10) / min_log_hz) / logstep
    return torch.where(frequencies >= min_log_hz, log_mels, mels)


def mel_to_hz(mels, htk: bool = False) -> torch.Tensor:
    """Inverse of :func:`hz_to_mel`, float32."""
    mels = torch.as_tensor(mels, dtype=torch.float32)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = float(np.log(6.4) / 27.0)
    log_freqs = min_log_hz * torch.exp(logstep * (mels - min_log_mel))
    return torch.where(mels >= min_log_mel, log_freqs, freqs)


def hz_to_mel_np(frequencies, htk: bool = False) -> np.ndarray:
    """Slaney (default) or HTK mel scale, float64 numpy."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(frequencies >= min_log_hz,
                    min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz_np(mels, htk: bool = False) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


def hz_to_octs(frequencies, tuning: float = 0.0, bins_per_octave: int = 12) -> torch.Tensor:
    """Octave number of each frequency relative to A440 / 16 (with `tuning` in
    fractions of a bin), float32."""
    a440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return torch.log2(torch.as_tensor(frequencies, dtype=torch.float32) / (a440 / 16))


def hz_to_midi(frequencies):
    return 12 * (np.log2(frequencies) - np.log2(440.0)) + 69


def cq_to_chroma_matrix(n_input: int, bins_per_octave: int = 12, n_chroma: int = 12,
                        fmin: float | None = None, base_c: bool = True) -> np.ndarray:
    """Static (n_chroma, n_input) CQT-bin -> chroma fold matrix."""
    n_merge = float(bins_per_octave) / n_chroma
    if fmin is None:
        fmin = C1_HZ
    m = np.repeat(np.eye(n_chroma), round(n_merge), axis=1)
    m = np.roll(m, -int(n_merge // 2), axis=1)
    n_octaves = int(np.ceil(float(n_input) / bins_per_octave))
    m = np.tile(m, (1, n_octaves))[:, :n_input]

    midi_0 = hz_to_midi(fmin) % 12
    roll = midi_0 if base_c else midi_0 - 9
    roll = int(np.round(roll * (n_chroma / 12.0)))
    return np.roll(m, roll, axis=0).astype(np.float32)
