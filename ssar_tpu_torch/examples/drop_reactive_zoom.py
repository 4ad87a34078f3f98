"""Example script: drop-strength section morphs + onset-reactive noise.

Port of the JAX package's ``examples/drop_reactive_zoom.py``: long-term
RMS ("drop strength") interpolates between two palette regions (calm
against drop), while band-split onsets of the percussive component drive
the noise.  Runs on the CUDA card unless ``--device`` says otherwise::

    python -m ssar_tpu_torch.examples.drop_reactive_zoom --audio_file song.wav

Without ``--audio_file`` it renders the JAX script's 6 s synthetic demo
track.
"""
import argparse

import numpy as np
import torch

from ssar_tpu_torch.audio.beat import onset_strength
from ssar_tpu_torch.audio.features import drop_strength, percussive
from ssar_tpu_torch.audio.processing import high_pass, low_pass, normalize
from ssar_tpu_torch.gan.render import render_latents_to_video
from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
from ssar_tpu_torch.gan.wrapper import StyleGAN2, make_noise_pyramid
from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.generate.latent import spline_loop_latents
from ssar_tpu_torch.ops.gaussian import gaussian_filter
from ssar_tpu_torch.utils.device import full_precision, resolve_device


def demo_track(sr: int) -> np.ndarray:
    """6 s of a rising 110 Hz tone with a click every third of a second."""
    t = np.arange(sr * 6) / sr
    audio = (0.3 * np.sin(2 * np.pi * 110 * t) * (t / t.max())).astype(np.float32)
    audio[:: sr // 3] += 1.2
    return audio


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_file", default=None)
    p.add_argument("--model_file", default=None)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--out", default="output/drop_reactive.mp4")
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
        drop = normalize(drop_strength(audio, sr)[:, 0])  # (T,)
        T = drop.shape[0]

        calm = spline_loop_latents(G.mapper(keys.normal(keys.PRNGKey(0), (6, 512), device=device)), T)
        wild = spline_loop_latents(G.mapper(keys.normal(keys.PRNGKey(1), (6, 512), device=device)), T, n_loops=4)
        latents = calm * (1 - drop[:, None, None]) + wild * drop[:, None, None]

        perc = percussive(audio)
        ons_low = normalize(onset_strength(low_pass(perc, sr), sr))
        ons_high = normalize(onset_strength(high_pass(perc, sr), sr))

        base = keys.normal(keys.PRNGKey(2), (T, 1, 64, 64), device=device)
        base = gaussian_filter(base, 2.0)
        noise = base * (0.5 + ons_low[:, None, None, None] + 0.5 * ons_high[:, None, None, None])
        pyramid = make_noise_pyramid(noise, config=cfg)

    render_latents_to_video(G.synthesizer, latents, pyramid[: G.synthesizer.n_noises_used], args.out, fps=fps,
                            output_size=(args.resolution, args.resolution), audio_file=args.audio_file)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
