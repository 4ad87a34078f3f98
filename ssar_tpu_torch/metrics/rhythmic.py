"""Rhythmic audio-reactivity metric, and the study of candidate metrics.

Counterpart of ``ssar_tpu/metrics/rhythmic.py``: the onset envelope of the
audio's percussive part and the video's framewise absdiff envelope go through
the same post-processing (smooth, clip at the peaks' percentile, clamp from
below, smooth, unit norm) and are compared by their dot product.  The video's
absdiff is ``ops/absdiff.py:absdiff``, the hand-written kernel (B2) on the
card; the percussive part's HPSS runs the sliding-median kernel (B1).

``dtw_distance`` is host numpy.  ``metric_sensitivity_study`` perturbs the
envelopes on the host with the reference's ``RandomState`` draws and scores
them there (cosine, mse, the sequential DTW), except ``xi``, which runs on the
study's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..audio.beat import onset_strength
from ..audio.features import percussive
from ..ops.absdiff import absdiff
from ..ops.gaussian import gaussian_filter
from ..ops.quantile import masked_quantile, quantile
from ..ops.resample import resample
from ..utils.device import full_precision, resolve_device


def percentile_clip(signal: torch.Tensor, percent: float) -> torch.Tensor:
    """Clamp each channel to [0, the `percent`-quantile of its local peaks]
    (samples strictly above both neighbours; the edges compare with
    themselves), then divide it by its maximum."""
    squeeze = signal.ndim < 2
    if squeeze:
        signal = signal[:, None]
    prev = torch.cat([signal[:1], signal[:-1]])
    nxt = torch.cat([signal[1:], signal[-1:]])
    peaks = (signal > prev) & (signal > nxt)
    thresh = masked_quantile(signal, peaks, percent / 100.0, dim=0)
    out = torch.minimum(torch.clamp(signal, min=0.0), thresh)
    out = out / (out.amax(dim=0) + 1e-12)
    return out[:, 0] if squeeze else out


def _postprocess(x: torch.Tensor, fps: float, q: float = 0.025) -> torch.Tensor:
    x = gaussian_filter(x, fps / 12)
    x = percentile_clip(x, (1 - q) * 100)
    x = torch.clamp(torch.maximum(x, quantile(x, 4 * q, axis=0)), max=1.0)
    x = gaussian_filter(x, fps / 24)
    return x / (torch.linalg.vector_norm(x) + 1e-12)


def video_absdiff_env(video: torch.Tensor) -> torch.Tensor:
    """(T, C, H, W) -> (T,) framewise sum of |frame[t+1] - frame[t]|."""
    return absdiff(video)


def _audio_at_rate(audio, sr: int, fps: int, device) -> tuple[torch.Tensor, int]:
    """Mono float32 audio on `device`, resampled to 1024 * fps when it is not."""
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device)
    if audio.ndim == 2:
        audio = audio.mean(dim=0)
    if round(sr) != round(fps * 1024):
        audio = resample(audio, int(sr), int(fps * 1024), lowpass_filter_width=6)
        sr = int(fps * 1024)
    return audio, sr


def rhythmic_reactivity(audio, sr: int, video, fps: int, device=None) -> torch.Tensor:
    """Dot product of the post-processed percussive onset envelope of `audio`
    ((L,) or (channels, L)) and the absdiff envelope of `video` ((T, C, H, W)
    in [0, 1]), over their common length: a 0-d tensor in [0, 1].  Runs on
    `device` (the card unless ``device="cpu"``) with TF32 off."""
    device = resolve_device(device)
    with full_precision():
        audio, sr = _audio_at_rate(audio, sr, fps, device)
        video = torch.as_tensor(video, dtype=torch.float32).to(device)
        audio_env = _postprocess(onset_strength(percussive(audio), sr), fps)
        video_env = _postprocess(video_absdiff_env(video), fps)
        n = min(audio_env.shape[0], video_env.shape[0])
        return torch.dot(audio_env[:n], video_env[:n])


# ------------------------------------------------ metric validation study --
def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Plain O(T^2) dynamic-time-warping distance (host numpy)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n, m = len(a), len(b)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    cost = np.abs(a[:, None] - b[None, :])
    for i in range(1, n + 1):
        D[i, 1:] = cost[i - 1]
        for j in range(1, m + 1):
            D[i, j] += min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[n, m])


def metric_sensitivity_study(audio_env, env_sets: dict, strengths: int = 12,
                             seed: int = 0, out_dir: str | None = None,
                             device: str | torch.device | None = None):
    """Sensitivity of candidate similarity metrics (xi, cosine, dtw, mse) to
    controlled perturbations of envelopes (emphasize, power, scale, offset,
    permute) over a grid of strengths, each envelope set scored against the
    audio onset envelope.  The perturbations, cosine, mse and DTW are host
    numpy, the permutations from ``np.random.RandomState(seed)`` in the
    reference's order; ``xi`` runs on `device` (the CUDA device unless
    ``device="cpu"``).

    env_sets: {name: (n_envs, T) array}.  Returns records
    [{transform, metric, envelope_set, strength, mean, std}], also written to
    ``out_dir/metric_sensitivity.csv`` when `out_dir` is given and pandas
    imports."""
    from .correlation import xi

    dev = resolve_device(device)
    audio_env = np.asarray(audio_env, np.float32).reshape(-1)
    T = audio_env.shape[0]
    rng = np.random.RandomState(seed)

    def permute_frames(envs, s):
        res = np.array(envs)
        k = round(res.shape[1] * float(s))
        if k > 0:
            for e in range(res.shape[0]):
                to = rng.permutation(res.shape[1])[:k]
                res[e, to] = res[e, to[rng.permutation(k)]]
        return res

    f32 = np.float32
    transforms = {
        "emphasize": (lambda e, s: e * (1 + np.tanh(f32(s) * (e - f32(0.5)))), np.linspace(0.01, 5, strengths)),
        "power": (lambda e, s: np.maximum(e, f32(0.0)) ** f32(s), np.linspace(0.01, 5, strengths)),
        "scale": (lambda e, s: f32(s) * e, np.linspace(-1, 5, strengths)),
        "offset": (lambda e, s: np.roll(e, int(s), axis=-1),
                   np.unique(np.linspace(-T // 4, T // 4, strengths).astype(int))),
        "permute": (permute_frames, np.linspace(0, 1, strengths)),
    }

    def cos(a, b):
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + f32(1e-12)))

    metrics = {
        "xi": lambda a, b: float(xi(torch.from_numpy(a).to(dev),
                                    torch.from_numpy(np.ascontiguousarray(b)).to(dev))),
        "cos": cos,
        "dtw": dtw_distance,
        "mse": lambda a, b: float(np.mean((a - b) ** 2)),
    }

    records = []
    for tname, (tf, ss) in transforms.items():
        for mname, metric in metrics.items():
            for ename, envs in env_sets.items():
                envs = np.asarray(envs, np.float32)[:, :T]
                for s in ss:
                    vals = [metric(audio_env, env) for env in tf(envs, s)]
                    records.append({"transform": tname, "metric": mname,
                                    "envelope_set": ename, "strength": float(s),
                                    "mean": float(np.mean(vals)), "std": float(np.std(vals))})
    if out_dir is not None:
        from pathlib import Path
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        try:
            import pandas as pd

            pd.DataFrame(records).to_csv(out / "metric_sensitivity.csv")
        except ImportError:
            pass
    return records
