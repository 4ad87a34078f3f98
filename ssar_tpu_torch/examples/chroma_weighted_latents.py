"""Example script: chroma-weighted latent mixing (the classic recipe).

Port of the JAX package's ``examples/chroma_weighted_latents.py``: each
chroma bin drives one palette latent, onsets modulate the noise amplitude.
Runs on the CUDA card unless ``--device`` says otherwise::

    python -m ssar_tpu_torch.examples.chroma_weighted_latents --audio_file song.wav

Without ``--audio_file`` it renders the JAX script's 6 s synthetic demo
track.
"""
import argparse

import numpy as np
import torch

from ssar_tpu_torch.audio.features import chromagram, onsets
from ssar_tpu_torch.gan.render import render_latents_to_video
from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
from ssar_tpu_torch.gan.wrapper import StyleGAN2, make_noise_pyramid
from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.ops.gaussian import gaussian_filter
from ssar_tpu_torch.utils.device import full_precision, resolve_device


def demo_track(sr: int) -> np.ndarray:
    """6 s of a 220 Hz tone with a slow tremolo and a click every half second."""
    t = np.arange(sr * 6) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 0.25 * t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    return audio


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_file", default=None)
    p.add_argument("--model_file", default=None)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--out", default="output/chroma_latents.mp4")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    fps = args.fps
    sr = 1024 * fps
    if args.audio_file:
        from ssar_tpu_torch.ops.resample import resample
        from ssar_tpu_torch.train.data import load_audio

        audio, in_sr = load_audio(args.audio_file)
        audio = resample(torch.as_tensor(audio, device=device), int(in_sr), sr, lowpass_filter_width=6)
    else:
        audio = torch.as_tensor(demo_track(sr), device=device)

    cfg = StyleGAN2Config(resolution=args.resolution)
    G = StyleGAN2(model_file=args.model_file, config=cfg, device=device)

    with torch.no_grad(), full_precision():
        chroma = chromagram(audio, sr)            # (T, 12)
        chroma = chroma / (chroma.sum(dim=1, keepdim=True) + 1e-8)
        ons = onsets(audio, sr)[:, 0]             # (T,)

        palette = G.mapper(keys.normal(keys.PRNGKey(0), (12, 512), device=device))
        latents = torch.einsum("TC,CNL->TNL", chroma, palette)
        latents = gaussian_filter(latents, fps / 24)

        T = latents.shape[0]
        base_noise = keys.normal(keys.PRNGKey(1), (T, 1, 64, 64), device=device)
        base_noise = gaussian_filter(base_noise, 3.0) * ons[:, None, None, None]
        pyramid = make_noise_pyramid(base_noise, config=cfg)

    render_latents_to_video(G.synthesizer, latents, pyramid[: G.synthesizer.n_noises_used], args.out, fps=fps,
                            output_size=(args.resolution, args.resolution), audio_file=args.audio_file)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
