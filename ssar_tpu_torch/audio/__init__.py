"""Audio DSP and the 59-dim feature stack.

Re-exports the names that ``ssar_tpu/audio/__init__.py`` exports, each the
port's counterpart of the same name (importing this package builds no
kernel).
"""
from .beat import fourier_tempogram, onset_strength, onset_strength_multi, plp
from .beat_host import beat_track, estimate_tempo
from .constantq import cqt, vqt
from .convert import hz_to_mel, mel_to_hz, power_to_db
from .features import (
    FEATURE_NAMES,
    N_FEATURES,
    audio2features,
    chromagram,
    drop_strength,
    harmonic,
    mfcc,
    onsets,
    percussive,
    pulse,
    rms,
    spectral_contrast,
    spectral_flatness,
    tonnetz,
)
from .pitch import estimate_tuning, piptrack
from .processing import (
    emphasize,
    gaussian_filter,
    high_pass,
    low_pass,
    mid_pass,
    normalize,
    onset_envelope,
    spectral_flux,
    standardize,
)
from .segment import laplacian_segmentation, laplacian_segmentation_rosa, recurrence_matrix
from .spectral import chroma_cens, chroma_cqt, hpss, istft, melspectrogram, spectrogram, stft
