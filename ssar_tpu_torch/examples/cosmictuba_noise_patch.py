"""Example patch: the "Cosmic Tuba" set closer, a dedicated high-frequency
noise modulator and the triple-smoothness noise stack.

Port of the JAX package's ``examples/cosmictuba_noise_patch.py`` (the
reference's 21_cosmictuba):
- ``high_noise_mod = percentile_clip(main_weight ** 2, 97)``, a separate
  spiky modulator for the finest noise;
- three noise fields at smoothness 20 / 5 / 1.5 blended in order: the high
  modulator pulls toward the noisiest, the low one toward the middle;
- extra onset gating only for ``width > 16`` scales;
- ``noise /= noise.std(); noise /= 1.666`` as the final normalisation (the
  population std, as the JAX package's);
- ``height > 128 -> None`` scale cutoff.
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 2, causal=0.25)
    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=2.5), 0.5, 0.5)
        * args.drop_weight)
    args.high_noise_mod = ar.percentile_clip(args.main_weight ** 2, 97)
    args.low_noise_mod = ar.normalize((1 - args.drop_weight) * args.main_weight)
    return args


def get_latents(selection, args):
    half = selection.shape[0] // 2
    intro = ar.slerp_loops(selection[:half], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[half:], args.n_frames, 3, smoothing=4)
    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 2.5)


def get_noise(height, width, scale, num_scales, args):
    if height > 128:
        return None
    device = args.audio.device
    k1, k2, k3 = keys.split(keys.PRNGKey(21 + scale), 3)
    shape = (args.n_frames, height, width)
    noise = ar.gaussian_filter(keys.normal(k1, shape, device=device), 20)
    noisy = ar.gaussian_filter(keys.normal(k2, shape, device=device), 5)
    noisier = ar.gaussian_filter(keys.normal(k3, shape, device=device), 1.5)

    hi = args.high_noise_mod[:, None, None]
    noise = hi * noisier + (1 - hi) * noise
    lo = args.low_noise_mod[:, None, None]
    noise = lo * noisy + (1 - lo) * noise
    if width > 16:
        onsets = ((args.drum_onsets + args.main_weight) / 2)[:, None, None]
        noise = onsets * noisier + (1 - onsets) * noise
    noise = noise / noise.std(correction=0)
    return noise / 1.666
