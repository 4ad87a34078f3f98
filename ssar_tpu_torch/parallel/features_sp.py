"""Long-form audio features: the two-pass chunked stack on one card.

Counterpart of the single-device part of ``ssar_tpu/parallel/features_sp.py``
(``audio2features_long``; the sharded pass waits for ``torch.distributed``).

Pass 1 (per chunk, heavy): the track is cut into overlapping chunk windows
that carry ``HALO_FRAMES`` of context on each side, clamped to the track so
that no padded sample enters a whole-track statistic.  Each chunk yields its
frame-local features (mfcc, chroma, tonnetz, contrast, flatness) and raw
envelopes (the four onset bands' mel power before dB, eight band RMS).  The
chunks run one after another, as the reference's ``lax.map`` does: each
chunk's two HPSS passes (the re-separation inside the chromagram is the
second) launch the sliding-median kernel twice each, so a track of
``n_chunks`` chunks makes ``4 * n_chunks + 2`` launches with the tuning
estimate's HPSS (14 for 180 s at the default 1440-frame chunks).

Pass 2 (whole track, small): halos are trimmed, the envelopes concatenated,
and everything with whole-track context runs on them as in the whole-track
stack: the onset bands' dB and flux, PLP's tempogram, the drop strength's
emphasis, the percentile clamps and the smoothing.  Frames within a halo of a
chunk boundary differ slightly from ``audio2features``'s.
"""
from __future__ import annotations

import math

import torch

from ..audio import features as FT
from ..audio.beat import mel_power_multi, onset_env_from_melpower, plp_from_onset_env
from ..audio.pitch import estimate_tuning
from ..audio.processing import emphasize, gaussian_filter, high_pass, low_pass
from ..ops.quantile import clamp_lower_percentile, clamp_peaks_percentile
from ..ops.resample import resample
from ..utils.device import full_precision, resolve_device

# Receptive half-width of the heaviest local op chain: bottom-octave CQT
# filters (~32 frames) + CENS temporal smoothing (21) + resampler kernels.
HALO_FRAMES = 64


def _core(audio: torch.Tensor, sr: int, tuning: float):
    """(Lc,) waveform chunk -> frame-local features and raw envelopes:
    (local (Tc, 46), mel_bands (4, n_mels, Tc), rms (8, Tc)), where local is
    [mfcc 20 | chroma 12 | tonnetz 6 | contrast 7 | flatness 1]."""
    harm, perc = FT.harmonic_percussive(audio)
    chroma = FT.chromagram(harm, sr, tuning)
    local = torch.cat([FT.mfcc(audio, sr), chroma, FT.tonnetz(None, sr, chroma=chroma),
                       FT.spectral_contrast(audio, sr), FT.spectral_flatness(audio, sr)], dim=1)

    # raw onset-band mel power (percussive + low/mid/high): dB'd over the whole track
    hp_band = high_pass(perc, sr)
    mel_bands = mel_power_multi(torch.stack([perc, low_pass(perc, sr), low_pass(hp_band, sr), hp_band]), sr)

    # raw band RMS (harmonic x4, full x4): the drop strength's emphasis is whole-track
    hp_h, hp_a = high_pass(harm, sr), high_pass(audio, sr)
    rms = FT.rms_multi(torch.stack([harm, low_pass(harm, sr), low_pass(hp_h, sr), hp_h,
                                    audio, low_pass(audio, sr), low_pass(hp_a, sr), hp_a]))
    return local, mel_bands, rms


def _chunk_plan(T: int, n_chunks: int, halo_frames: int = HALO_FRAMES):
    """Clamped chunk windows and each chunk's keep offset (see the module doc):
    (frames per chunk, halo, chunk frames with halos, window starts, keep
    offsets)."""
    fpc = math.ceil(T / n_chunks)
    halo = min(halo_frames, fpc)
    chunk_frames = fpc + 2 * halo
    starts = [min(max(i * fpc - halo, 0), T - chunk_frames) for i in range(n_chunks)]
    keep = [i * fpc - st for i, st in zip(range(n_chunks), starts)]
    return fpc, halo, chunk_frames, starts, keep


def _assemble(local, mel_bands, rms, keep_off, fpc: int, T: int, sr: int, fps: int, clamp: bool,
              smooth: bool) -> torch.Tensor:
    """Pass 2: each chunk's kept frames [keep, keep + fpc) concatenated, the
    whole-track envelopes' features and the post-processing.  Inputs are lists
    of the chunks' pass-1 outputs."""

    def trim_cat(parts, time_axis):
        return torch.cat([x.narrow(time_axis, k, min(fpc, x.shape[time_axis] - k))
                          for x, k in zip(parts, keep_off)], dim=time_axis).narrow(time_axis, 0, T)

    local = trim_cat(local, 0)      # (T, 46)
    M = trim_cat(mel_bands, 2)      # (4, n_mels, T)
    R = trim_cat(rms, 1)            # (8, T)

    onsets = onset_env_from_melpower(M, aggregate="mean")                 # (4, T)
    pulse = plp_from_onset_env(onset_env_from_melpower(M[:1], aggregate="median")[0], sr)
    drops = [emphasize(gaussian_filter(R[i][:, None], 10), strength=10, percentile=50) for i in range(4, 8)]
    single = [local[:, 45], *onsets, pulse, *R[:4], *drops]
    feats = torch.cat([local[:, :45]] + [s.reshape(-1, 1) for s in single], dim=1)

    if clamp:
        P = 2.5
        feats = clamp_peaks_percentile(feats, 100 - P)
        feats = clamp_lower_percentile(feats, 4 * P)
    if smooth:
        feats = gaussian_filter(feats, 0.1 * fps)
    return feats


def audio2features_long(audio, sr: int, fps: int, chunk_frames: int = 1440, clamp: bool = True,
                        smooth: bool = True, tuning: float | None = None,
                        device: str | torch.device | None = None) -> torch.Tensor:
    """(T, 59) feature stack of a long mono waveform (numpy or tensor),
    resampled to ``1024 * fps``, in chunks of about `chunk_frames` frames.

    A track no longer than one chunk with its halos goes to ``audio2features``.
    ``tuning=None`` estimates the tuning once on the host from the harmonic
    part of the first 4 s; a float fixes it.  Runs on the CUDA device unless
    ``device`` says otherwise (``"cpu"``), with TF32 off.
    """
    device = resolve_device(device)
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device)
    target_sr = fps * 1024
    with torch.no_grad(), full_precision():
        if sr != target_sr:
            audio = resample(audio, int(sr), target_sr, lowpass_filter_width=6)
            sr = target_sr

        T = audio.shape[0] // 1024
        n_chunks = max(math.ceil(T / chunk_frames), 1)
        fpc, _, cf, starts, keep = _chunk_plan(T, n_chunks)
        if T <= cf:
            kwargs = {} if tuning is None else {"tuning": float(tuning)}
            return FT.audio2features(audio, sr, fps, clamp=clamp, smooth=smooth, device=device, **kwargs)

        track = audio[: T * 1024]
        if tuning is None:
            tuning = estimate_tuning(FT.harmonic(track[: 4 * sr]), sr, bins_per_octave=36)
        outs = [_core(track[s0 * 1024 : (s0 + cf) * 1024], sr, float(tuning)) for s0 in starts]
        local, mel_bands, rms = zip(*outs)
        return _assemble(local, mel_bands, rms, keep, fpc, T, sr, fps, clamp, smooth)
