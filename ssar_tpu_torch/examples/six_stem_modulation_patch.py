"""Six-stem modulation pipeline (ouroboromorphism idiom).

Port of the JAX package's ``examples/six_stem_modulation_patch.py``: one
modulation signal per source-separated stem, each with its own feature
chain, each driving a different aspect of the video; the stem files fall
back to the mix when absent, so it runs on a bare mix:

- vocals  -> brightness: per-frame truncation automation
- synth   -> chroma-argmax melody latents
- plucks  -> high-band sparkle noise
- drums   -> latent punches
- bass    -> slow structural crossfade
- fx      -> section switches (Laplacian segmentation)

Each stem's envelope is taken at the stem's own sample rate.
"""
import os

import torch

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def _stem_audio(args, name, fmin=None, fmax=None):
    """Stem file if present, else the mix."""
    if args.audio_file:
        path = os.path.join(os.path.splitext(args.audio_file)[0], f"{name}.wav")
        if os.path.exists(path):
            a, sr, _ = ar.load_audio(path, device=args.audio.device)
            return a, sr
    return args.audio, args.sr


def initialize(args):
    voc, vsr = _stem_audio(args, "vocals")
    args.vocal_mod = ar.gaussian_filter(ar.rms(voc, vsr, args.n_frames, fmin=300, fmax=4000, smooth=6), 2)

    syn, ssr = _stem_audio(args, "other")
    args.synth_chroma = ar.chroma(syn, ssr, args.n_frames).argmax(dim=1)

    plk, psr = _stem_audio(args, "plucks")
    args.pluck_mod = ar.compress(ar.onsets(plk, psr, args.n_frames, fmin=4000, clip=96, smooth=1), 0.4, 0.6)

    drm, dsr = _stem_audio(args, "drums")
    args.drum_mod = ar.gaussian_filter(ar.compress(
        ar.onsets(drm, dsr, args.n_frames, fmin=150, fmax=2000, clip=94, smooth=1.5), 0.5, 0.5), 1.5, causal=0.2)

    bas, bsr = _stem_audio(args, "bass")
    args.bass_mod = ar.rms(bas, bsr, args.n_frames, fmax=120, smooth=60)

    args.sections = ar.laplacian_segmentation(args.audio, args.sr, args.n_frames, ks=(4,))[:, 0]
    return args


def get_latents(selection, args):
    n = selection.shape[0]
    # fx / sections pick the base palette quarter per section
    sec = torch.clamp(args.sections, 0, 3)
    q = max(n // 4, 1)
    per_section = torch.stack([
        ar.slerp_loops(selection[min((k % 4) * q, n - 2):][:q + 1], args.n_frames, 1 + k, smoothing=6)
        for k in range(4)])
    base = per_section[sec, torch.arange(args.n_frames, device=sec.device)]

    # synth melody keys into the palette; drums punch an accent latent
    melody = ar.gaussian_filter(selection[args.synth_chroma % n], 2)
    latents = (1 - args.vocal_mod[:, None, None]) * base + args.vocal_mod[:, None, None] * melody
    latents = ar.ModulatedLatents(0.5 * args.drum_mod, latents, selection[-1])

    # bass owns the slow structural layers (0-4)
    slow = ar.slerp_loops(selection[-(q + 1):], args.n_frames, 0.5, smoothing=24)
    w = args.bass_mod[:, None, None]
    latents[:, :4] = (w * slow + (1 - w) * latents)[:, :4]
    return ar.gaussian_filter(latents, 1.5)


def get_truncation(args):
    # vocals open up brightness: psi 0.6 -> 1.0 with vocal energy
    return 0.6 + 0.4 * args.vocal_mod


def get_noise(height, width, scale, num_scales, args):
    if height > 64:
        return None
    device = args.audio.device
    key = keys.PRNGKey(11 + scale)
    calm = ar.gaussian_filter(keys.normal(key, (args.n_frames, height, width), device=device), 15)
    sparkle = keys.normal(keys.split(key)[1], (args.n_frames, height, width), device=device)
    m = args.pluck_mod[:, None, None]
    noise = (1 - m) * calm + m * sparkle
    return noise / (2.5 * noise.std(correction=0))
