"""Music information retrieval for the random-patch system.

Counterpart of ``ssar_tpu/generate/mir.py``: the 8 named audio features on
the device; tempo (log-normal prior), beats and the per-(feature, k)
Laplacian segmentations on the host in numpy (every clip has its own beat
count, and the matrices have tens of rows); salience weighting of the
envelopes.  Four of the features separate harmonic from percussive audio
(``chromagram``, ``tonnetz`` through its own chromagram, ``onsets``, and
``onsets`` again for the beat envelope): eight sliding-median launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..audio import features as FT
from ..audio.beat_host import beat_track, estimate_tempo
from ..audio.processing import gaussian_filter, normalize
from ..audio.segment import laplacian_segmentation_np, laplacian_segmentation_rosa
from ..utils.device import full_precision, resolve_device
from ..utils.profiling import span

AFEATFNS = [FT.chromagram, FT.tonnetz, FT.mfcc, FT.spectral_contrast, FT.spectral_flatness,
            FT.rms, FT.drop_strength, FT.onsets]
UNITFEATS = ["rms", "drop_strength", "onsets", "spectral_flatness"]
ALLFEATS = ["chromagram", "tonnetz", "mfcc", "spectral_contrast"] + UNITFEATS


def salience_weighted(envelope: torch.Tensor, short_sigma: float = 5, long_sigma: float = 80) -> torch.Tensor:
    """The envelope weighted by (short-term / long-term mean)^2, (T, D)."""
    if envelope.ndim > 1 and envelope.shape[1] == 1:
        envelope = envelope[:, 0]
    short = gaussian_filter(envelope, short_sigma, mode="reflect")
    long = gaussian_filter(envelope, long_sigma, mode="reflect")
    weighted = (short / long) ** 2 * envelope
    if weighted.ndim < 2:
        weighted = weighted[:, None]
    return weighted


def retrieve_music_information(audio, sr: int, ks=(2, 4, 6, 8, 12, 16), include_rosa: bool = True,
                               device=None, seconds: dict | None = None):
    """-> (features: name -> (T, D) on the device, segmentations: (name, k)
    and ("rosa", k) -> (T,) int64 labels on the device, tempo in BPM).

    `audio` is a mono waveform (numpy or tensor) at `sr`.  Runs on the CUDA
    device unless `device` says otherwise.  When `seconds` is a dict, the
    host seconds of the spans ``mir.features`` (the device features, and the
    closing smoothing) are added to its "features", and those of
    ``mir.beats``, ``mir.segmentation`` and ``mir.rosa`` to "segmentation"."""
    device = resolve_device(device)
    audio = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(audio, torch.Tensor) else audio,
                            dtype=torch.float32).to(device)
    with span("mir.features", seconds, "features"), torch.no_grad(), full_precision():
        features = {fn.__name__: fn(audio, sr) for fn in AFEATFNS}
        onset_env = FT.onsets(audio, sr)[:, 0].cpu().numpy()
        host = {name: f.cpu().numpy() for name, f in features.items()}

    with span("mir.beats", seconds, "segmentation"):
        tempo = estimate_tempo(onset_env, sr=sr, hop_length=1024, max_tempo=240, prior_scale=400.0, prior_s=1.0)
        _, beats = beat_track(onset_env, sr=sr, hop_length=1024, bpm=tempo, trim=False)
        beats = [int(b) for b in beats if b > 0]

    segmentations = {}
    with span("mir.segmentation", seconds, "segmentation"):
        for name, feature in host.items():
            segs = laplacian_segmentation_np(feature, beats, ks=ks)
            for k, s in zip(ks, segs):
                segmentations[(name, k)] = torch.as_tensor(np.argmax(s, axis=1), device=device)
    if include_rosa:
        with span("mir.rosa", seconds, "segmentation"):
            n_frames = host[AFEATFNS[0].__name__].shape[0]
            rosa_seg = laplacian_segmentation_rosa(audio, sr, n_frames, ks=list(ks))
            for j, k in enumerate(ks):
                segmentations[("rosa", k)] = torch.as_tensor(rosa_seg[:, j], device=device)

    with span("mir.features", seconds, "features"), torch.no_grad():
        features = {k: normalize(salience_weighted(gaussian_filter(af, sigma=2))) for k, af in features.items()}
    return features, segmentations, tempo
