"""Example patch: the "Contact" redrocks set piece, robust drop detection
with a constant-floor fallback, fully causal drum smoothing, and a
quiet-section noise modulator.

Port of the JAX package's ``examples/redrocks_contact_patch.py`` (the
reference's 4_contact):
- drum-stem onsets -> compress -> ``gaussian_filter(..., causal=0)``;
- ``drop_weight = 0.888 * rms(smooth=100) ** 2`` with a constant-0.125
  fallback when the track is too quiet for RMS peaks;
- ``main_weight = 0.888 * compress(onsets(clip=97)) * drop_weight``;
- ``low_noise_mod = normalize((1 - drop_weight) * main_weight)``: transient
  energy that only bites outside the drops, driving the coarse noise.

Stems are read from the demucs convention (``<track>/drums.wav`` /
``other.wav``) when present, each envelope at its stem's own sample rate;
the mix otherwise, so the patch renders standalone.
"""
import os

import torch

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def _stem(args, name):
    if not args.audio_file:
        return None
    path = os.path.join(os.path.splitext(args.audio_file)[0], f"{name}.wav")
    if not os.path.exists(path):
        return None
    audio, sr, _ = ar.load_audio(path, device=args.audio.device)
    return audio, sr


def initialize(args):
    drums = _stem(args, "drums")
    daudio, dsr = drums if drums is not None else (args.audio, args.sr)
    args.drum_onsets = ar.onsets(daudio, dsr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = 0.888 * ar.gaussian_filter(args.drum_onsets, 3, causal=0)

    other = _stem(args, "other")
    focus, fsr = other if other is not None else (args.audio, args.sr)
    args.focus_chroma = ar.chroma(focus, fsr, args.n_frames).argmax(dim=1)

    # the reference guards rms() against a quiet track with a 0.125 floor;
    # the guard is a 0-d tensor on the audio's device, never read on the host
    drop = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    silent = ~torch.isfinite(drop).all() | (args.audio.abs().max() < 1e-6)
    args.drop_weight = torch.where(silent, torch.full_like(drop, 0.125), 0.888 * drop)

    args.main_weight = 0.888 * (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=3), 0.5, 0.5)
        * args.drop_weight)
    args.low_noise_mod = (1 - args.drop_weight) * args.main_weight
    args.low_noise_mod = 0.888 * ar.normalize(args.low_noise_mod)
    return args


def get_latents(selection, args):
    half = selection.shape[0] // 2
    intro = ar.slerp_loops(selection[:half], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[half:], args.n_frames, 2, smoothing=4)

    # the focus stem's chroma indexes the palette for the in-drop reactive layer
    reactive = ar.gaussian_filter(selection[args.focus_chroma % selection.shape[0]], 2)
    m = args.main_weight[:, None, None]
    drop = (1 - m) * drop + m * reactive

    intro = ar.ModulatedLatents(0.5 * args.drum_onsets, intro, selection[0])
    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 2)


def get_noise(height, width, scale, num_scales, args):
    if height > 256:
        return None
    device = args.audio.device
    k1, k2 = keys.split(keys.PRNGKey(4 + scale))
    base = ar.gaussian_filter(keys.normal(k1, (args.n_frames, height, width), device=device), 20)
    noisy = keys.normal(k2, (args.n_frames, height, width), device=device)
    # quiet-section transients flicker the coarse scales; drops the fine ones
    mod = args.low_noise_mod if scale < num_scales // 2 else args.main_weight
    return ar.ModulatedNoise(mod, base, noisy)
