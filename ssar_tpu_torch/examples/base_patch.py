"""Shared base patch: the ``from .base import *`` idiom.

Port of the JAX package's ``examples/base_patch.py``: one base module
computes the canonical driving signals (drum onsets, a chroma-argmax
"focus" melody track, a long-window drop weight and a combined main weight)
and supplies default latent and noise hooks that concrete patches override.
It is itself a complete patch.  It covers the envelopes, ``compress`` and
``gaussian_filter(causal=)``.

Stems (``<track>/drums.wav``, ``<track>/other.wav``) are used when present,
with band-filtered fallbacks so the patch runs on a bare mix.
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
    # drums -> sharp compressed onsets: onsets(fmin=200, clip=94, smooth) ->
    # compress(0.5, 0.5) -> gaussian
    drums = _stem(args, "drums")
    if drums is not None:
        args.drum_onsets = ar.onsets(drums[0], drums[1], args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    else:
        args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.gaussian_filter(ar.compress(args.drum_onsets, 0.5, 0.5), 2, causal=0)

    # melodic focus -> per-frame pitch class (chroma argmax)
    focus = _stem(args, "other")
    chrom = (ar.chroma(focus[0], focus[1], args.n_frames) if focus is not None
             else ar.chroma(args.audio, args.sr, args.n_frames))
    args.focus_chroma = chrom.argmax(dim=1)

    # slow build: squared long-window RMS; short tracks fall back to a
    # constant eighth
    if args.n_frames > 100:
        args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    else:
        args.drop_weight = 0.125 * torch.ones(args.n_frames, device=args.audio.device)

    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=3), 0.5, 0.5)
        * args.drop_weight)
    args.low_noise_mod = (1 - args.drop_weight) * args.main_weight
    return args


def get_latents(selection, args):
    """Default: drop / intro crossfade with drum punches."""
    intro = ar.slerp_loops(selection[:4], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[4:8], args.n_frames, 2, smoothing=4)
    intro = ar.ModulatedLatents(0.5 * args.drum_onsets, intro, selection[-1])
    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 2)


def get_noise(height, width, scale, num_scales, args):
    if height > 256:
        return None
    device = args.audio.device
    k1, k2, k3 = keys.split(keys.PRNGKey(scale), 3)
    smooth = ar.gaussian_filter(keys.normal(k1, (args.n_frames, height, width), device=device), 20)
    noisy = ar.gaussian_filter(keys.normal(k2, (args.n_frames, height, width), device=device), 5)
    noisier = ar.gaussian_filter(keys.normal(k3, (args.n_frames, height, width), device=device), 1.5)
    noise = smooth
    if height > 8:
        ons = ((args.drum_onsets + args.main_weight) / 2)[:, None, None]
        noise = ons * noisier + (1 - ons) * noise
        lo = args.low_noise_mod[:, None, None]
        noise = lo * noisy + (1 - lo) * noise
    return noise / (3 * noise.std(correction=0))
