"""Serve path: audio + reactor -> music video.

Counterpart of ``audio2video`` / ``_audio2video`` / ``latent2video`` in
``ssar_tpu/generate/audio2video.py``: features -> reactor -> (latents, noise
pyramid) -> batched StyleGAN2 render -> frame writer, with the reference's
noise duplication (noise0, then each pyramid level twice) and optional
residual re-centring around a seeded mapper latent; or a saved latent
sequence re-centred around one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..audio.features import audio2features
from ..gan.render import render_latents_to_video
from ..gan.wrapper import StyleGAN2Mapper, StyleGAN2Synthesizer
from ..utils.device import resolve_device


def duplicate_pyramid(noise: list) -> list:
    """[n0, n1, ..., nk] -> [n0, n1, n1, n2, n2, ...]."""
    return [noise[0]] + [n for nn in noise[1:] for n in (nn, nn)]


def load_wav(path: str):
    """Mono float32 waveform and sample rate of a .wav file (integer PCM is
    scaled to [-1, 1))."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max + 1)
    data = data.astype(np.float32)
    return (data.mean(1) if data.ndim == 2 else data), int(sr)


def react(model, features: torch.Tensor, generator: torch.Generator | None = None):
    """(T, F) features -> latents (T, n_ws, 512) and noise maps [(T, 1, s, s)]."""
    with torch.no_grad():
        latents, noise = model(features[None], generator=generator)
    return latents[0], [n[0][:, None] for n in noise]


def render_reaction(latents: torch.Tensor, noise: list, out_file: str | None = None,
                    model_file: str | None = None, output_size=(1024, 1024), fps: int = 24,
                    batch_size: int = 8, audio_file: str | None = None, offset: float = 0,
                    duration: float | None = None, seed: int | None = None, residual: bool = False,
                    gan_config=None, synthesizer: StyleGAN2Synthesizer | None = None, writer=None):
    """A reactor's latents and noise pyramid -> frames through `writer` (or an
    mp4 at `out_file`), on the latents' device.  Returns the writer."""
    device = latents.device
    if residual:
        mapper = StyleGAN2Mapper(model_file=model_file, config=gan_config, device=device)
        z = np.random.RandomState(seed if seed is not None else 0).randn(1, 512).astype(np.float32)
        latents = latents + mapper(z)[0]

    if synthesizer is None:
        synthesizer = StyleGAN2Synthesizer(model_file=model_file, output_size=output_size,
                                           config=gan_config, device=device)
    dup = duplicate_pyramid(noise)[: synthesizer.n_noises_used]
    start = int(fps * offset)
    end = int(fps * (offset + duration)) if duration is not None else latents.shape[0]
    return render_latents_to_video(synthesizer, latents[start:end], [n[start:end] for n in dup], out_file,
                                   fps=fps, output_size=output_size, batch_size=batch_size,
                                   audio_file=audio_file, audio_offset=offset, audio_duration=duration,
                                   writer=writer)


def latent2video(audio_file: str | None, latent_file: str, out_file: str | None = None,
                 model_file: str | None = None, output_size=(1024, 1024), fps: int = 24, batch_size: int = 8,
                 offset: float = 0, duration: float | None = None, seed: int = 123, gan_config=None,
                 device: str | torch.device | None = None, writer=None):
    """Render a saved latent sequence (.npy, (T, n_ws, 512)) to video: the
    sequence is re-centred as a residual around the mapper's latent of a
    seeded z, and sibling ``" - Noise {4,8,16,32}.npy"`` pyramids are picked
    up when all four are present.  Returns the writer."""
    device = resolve_device(device)
    latents = torch.as_tensor(np.load(latent_file), dtype=torch.float32)
    start = int(fps * offset)
    end = int(fps * (offset + duration)) if duration is not None else latents.shape[0]
    latents = latents[start:end].to(device)
    residuals = latents - latents.mean(dim=(0, 1))

    noise = []
    for s in (4, 8, 16, 32):
        try:
            n = np.load(latent_file.replace(".npy", f" - Noise {s}.npy"))[start:end]
        except FileNotFoundError:
            noise = []
            break
        noise.append(np.asarray(n, np.float32).reshape(n.shape[0], 1, s, s))

    mapper = StyleGAN2Mapper(model_file=model_file, config=gan_config, device=device)
    base = mapper(np.random.RandomState(seed).randn(1, 512).astype(np.float32))[0]
    synthesizer = StyleGAN2Synthesizer(model_file=model_file, output_size=output_size, config=gan_config,
                                       device=device)
    dup = duplicate_pyramid(noise)[: synthesizer.n_noises_used] if noise else None
    return render_latents_to_video(synthesizer, base + residuals, dup, out_file, fps=fps, output_size=output_size,
                                   batch_size=batch_size, audio_file=audio_file, audio_offset=offset,
                                   audio_duration=duration, writer=writer)


def audio2video(model, audio_file: str | None, out_file: str | None = None, model_file: str | None = None,
                output_size=(1024, 1024), fps: int = 24, batch_size: int = 8, offset: float = 0,
                duration: float | None = None, seed: int | None = None, residual: bool = False,
                gan_config=None, audio=None, sr: int | None = None,
                device: str | torch.device | None = None, synthesizer: StyleGAN2Synthesizer | None = None,
                writer=None):
    """Full path from a waveform (or a .wav file) to video.

    `model` is a ``LatentNoiseReactor`` on `device` (the CUDA device unless
    given); its base noise is drawn from a generator seeded with `seed`.
    """
    device = resolve_device(device)
    if audio is None:
        audio, sr = load_wav(audio_file)
    features = audio2features(audio, int(sr), fps, device=device)
    latents, noise = react(model, features, torch.Generator(device).manual_seed(seed or 0))
    return render_reaction(latents, noise, out_file, model_file=model_file, output_size=output_size,
                           fps=fps, batch_size=batch_size, audio_file=audio_file, offset=offset,
                           duration=duration, seed=seed, residual=residual, gan_config=gan_config,
                           synthesizer=synthesizer, writer=writer)
