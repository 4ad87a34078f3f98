"""Correlation test set: clips with known audio-reactivity.

Counterpart of ``ssar_tpu/metrics/generate.py``: four recipes render clips
whose audio-visual correlation is low, chroma-driven, onset-driven or both,
used to calibrate the reactivity scorer.  Every random draw goes through
``generate/keys.py`` in the JAX package's order and is made on the CPU, then
moved to the generator's device, so the card and the CPU render one seed
alike.
"""
from __future__ import annotations

import numpy as np
import torch

from ..audio.beat import onset_strength
from ..audio.features import harmonic, percussive
from ..audio.spectral import chroma_cens
from ..generate import keys
from ..generate.latent import spline_loop_latents
from ..ops.gaussian import gaussian_filter


def my_chromagram(audio: torch.Tensor, sr: int) -> torch.Tensor:
    """Chroma-CENS of the harmonic part, floored by its cosine-median nearest
    neighbour filter: (T, 12)."""
    from .chroma import nn_filter_cosine_median

    chroma = chroma_cens(harmonic(audio), sr)
    chroma = torch.minimum(chroma, nn_filter_cosine_median(chroma))
    return chroma.T


def my_audio_onsets(audio: torch.Tensor, sr: int) -> torch.Tensor:
    """Percussive onset strength, peak-percentile clipped and normalised: (T,)."""
    from .rhythmic import percentile_clip

    env = percentile_clip(onset_strength(percussive(audio), sr), 97.5)
    return env / (env.max() + 1e-12)


def _normal(key, shape, device) -> torch.Tensor:
    return keys.normal(key, shape).to(device)


def _std(x: torch.Tensor) -> torch.Tensor:
    return x.std(unbiased=False)


def _looped_noise(key, n_keys: int, N: int, size: int, device) -> torch.Tensor:
    noise = spline_loop_latents(_normal(key, (n_keys, 1, size * size), device), N)
    return noise.reshape(N, 1, size, size)


def low_correlation(key, mapper, audio, sr, n_frames, fps=24):
    k1, k2 = keys.split(key)
    n_keys = keys.randint(k1, max(2, n_frames // 192), max(3, n_frames // 24))
    ws = mapper(keys.normal(k1, (n_keys, 512)))
    latents = spline_loop_latents(ws, n_frames)
    return latents, _looped_noise(k2, n_keys, n_frames, 16, ws.device)


def high_chroma_correlation(key, mapper, audio, sr, n_frames, fps=24):
    chroma = my_chromagram(audio, sr)[:n_frames]
    chroma = chroma / (chroma.sum(dim=1, keepdim=True) + 1e-12)
    ws = mapper(keys.normal(key, (12, 512)))
    latents = gaussian_filter(torch.einsum("TC,CNL->TNL", chroma, ws), fps / 24)
    noise = gaussian_filter(_normal(key, (n_frames, 1, 32, 32), ws.device), 3 * fps)
    return latents, noise / (_std(noise) + 1e-12)


def high_onset_correlation(key, mapper, audio, sr, n_frames, fps=24):
    ons = my_audio_onsets(audio, sr)[:n_frames]
    ws = mapper(keys.normal(key, (2, 512)))
    latents = ws[0:1] * ons[:, None, None] + ws[1:2] * (1 - ons[:, None, None])
    latents = gaussian_filter(latents, fps / 24)
    noise = gaussian_filter(_normal(key, (n_frames, 1, 64, 64), ws.device), 3 * fps / 24)
    noise = noise / (_std(noise) + 1e-12)
    return latents, noise * ons[:, None, None, None]


def high_both_correlation(key, mapper, audio, sr, n_frames, fps=24):
    chroma = my_chromagram(audio, sr)[:n_frames]
    chroma = chroma / (chroma.sum(dim=1, keepdim=True) + 1e-12)
    ons = my_audio_onsets(audio, sr)[:n_frames]
    ws = mapper(keys.normal(key, (14, 512)))
    latents = (torch.einsum("TC,CNL->TNL", chroma, ws[:12])
               + ws[12:13] * ons[:, None, None] + ws[13:14] * (1 - ons[:, None, None])) / 2
    latents = gaussian_filter(latents, fps / 24)
    noise = gaussian_filter(_normal(key, (n_frames, 1, 64, 64), ws.device), 3 * fps / 24)
    noise = noise / (_std(noise) + 1e-12)
    return latents, noise * ons[:, None, None, None]


CORRELATION_RECIPES = {
    "low": low_correlation,
    "high_chroma": high_chroma_correlation,
    "high_onset": high_onset_correlation,
    "high_both": high_both_correlation,
}


@torch.no_grad()
def render_correlation_clip(recipe: str, audio, sr: int, G, fps: int = 24, seed: int = 0,
                            batch_size: int = 16) -> torch.Tensor:
    """-> (T, C, H, W) video in [0, 1] rendered with the chosen recipe by
    ``G`` (a ``gan.wrapper.StyleGAN2``), on G's device; T = len(audio) // 1024."""
    from ..gan.wrapper import make_noise_pyramid

    device = G.mapper.device
    audio = torch.as_tensor(np.asarray(audio, np.float32) if not torch.is_tensor(audio) else audio,
                            dtype=torch.float32).to(device)
    n_frames = audio.shape[0] // 1024
    latents, noise = CORRELATION_RECIPES[recipe](keys.PRNGKey(seed), G.mapper, audio, sr, n_frames, fps)
    pyramid = make_noise_pyramid(noise, config=G.config)
    n_used = G.synthesizer.n_noises_used
    frames = []
    for i in range(0, n_frames, batch_size):
        kw = {f"noise{j}": p[i : i + batch_size] for j, p in enumerate(pyramid[:n_used])}
        frames.append(torch.clamp((G.synthesizer(latents[i : i + batch_size], **kw) + 1) / 2, 0, 1))
    return torch.cat(frames).permute(0, 3, 1, 2)
