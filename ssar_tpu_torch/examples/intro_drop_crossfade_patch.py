"""Intro/drop crossfade with accent punches and scale-gated noise.

Port of the JAX package's ``examples/intro_drop_crossfade_patch.py`` (the
live-set idiom of the reference's 01_intro / 2_mirage): two latent
palettes (intro + drop) crossfaded by a long-window drop weight, drum
onsets punching an accent latent into the intro, and ``get_noise``
returning None above a cutoff resolution with a smooth / noisy / noisier
three-way blend below it.
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 3, causal=0)

    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.main_weight = 0.666 * ar.compress(
        ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=2.5), 0.5, 0.5) * args.drop_weight
    args.low_noise_mod = 0.75 * ar.normalize((1 - args.drop_weight) * args.main_weight)
    return args


def get_latents(selection, args):
    half = len(selection) // 2
    intro = ar.slerp_loops(selection[:half], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[half:], args.n_frames, 2, smoothing=4)

    # drum hits punch the first drop latent into the intro
    accent = args.drum_onsets[:, None, None]
    intro = (1 - 0.5 * accent) * intro + 0.5 * accent * selection[half][None]

    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 1.5)


def get_noise(height, width, scale, num_scales, args):
    if height > 256:
        return None  # upper scales keep the synthesizer's own noise

    device = args.audio.device
    k1, k2, k3 = keys.split(keys.PRNGKey(scale), 3)
    smooth = ar.gaussian_filter(keys.normal(k1, (args.n_frames, height, width), device=device), 20)
    noisy = ar.gaussian_filter(keys.normal(k2, (args.n_frames, height, width), device=device), 5)
    noisier = ar.gaussian_filter(keys.normal(k3, (args.n_frames, height, width), device=device), 1.5)

    if height > 8:
        on = ((args.drum_onsets + args.main_weight) / 2)[:, None, None]
        out = on * noisier + (1 - on) * smooth
        lo = args.low_noise_mod[:, None, None]
        out = lo * noisy + (1 - lo) * out
    else:
        out = smooth
    return out / (out.std(correction=0) + 1e-8)
