"""Visual beats: onset envelopes and beat times from a video's motion.

Counterpart of ``ssar_tpu/video/visual_beats.py``: the directogram of the
optical flow (or the spatial spectrum), its spectral flux and onset envelope
on the video's device, and beat times from the envelope by the host beat
tracker that the audio uses (``audio/beat_host.py``).
"""
from __future__ import annotations

import torch

from ..audio.beat_host import beat_track
from ..audio.processing import onset_envelope, spectral_flux
from .features import directogram, optical_flow, video_spectrogram


def video_onsets(video: torch.Tensor, backend: str = "torch") -> torch.Tensor:
    """(T, C, H, W) -> (T,) motion onset envelope."""
    return onset_envelope(spectral_flux(directogram(optical_flow(video, backend=backend))))


def video_spectral_beat_envelope(video: torch.Tensor) -> torch.Tensor:
    return onset_envelope(spectral_flux(video_spectrogram(video)))


def visual_beats(video: torch.Tensor, fps: float = 24.0, backend: str = "torch"):
    """-> (bpm, beat frame indices) of the motion onset envelope."""
    env = video_onsets(video, backend=backend).cpu().numpy()
    return beat_track(env, sr=fps * 1024, hop_length=1024)
