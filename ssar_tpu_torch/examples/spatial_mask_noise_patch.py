"""Example patch: spatial control of noise with a soft circular mask.

Port of the JAX package's ``examples/spatial_mask_noise_patch.py`` (the
reference's temper idiom): chromagram-weighted latents modulated by
split-band drum onsets, and a circular mask that routes *low* onsets to
noise inside the disc on coarse scales while *high* onsets drive noise
outside the disc on fine scales.

Render with::

    from ssar_tpu_torch.generate import audioreactive as ar
    mod = ar.load_patch_module("ssar_tpu_torch/examples/spatial_mask_noise_patch.py")
    latents, noises = ar.render_patch(mod, audio, sr, palette=palette,
                                      synthesizer=syn, out_file="out.mp4")
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.lo_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmax=150, smooth=5, clip=97, power=2)
    args.hi_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=500, smooth=5, clip=99, power=2)
    return args


def get_latents(selection, args):
    chroma = ar.chroma(args.audio, args.sr, args.n_frames)
    latents = ar.gaussian_filter(ar.chroma_weight_latents(chroma, selection), 4)

    lo = args.lo_onsets[:, None, None]
    hi = args.hi_onsets[:, None, None]
    # onsets substitute dedicated accent latents in place of the chroma blend
    latents = hi * selection[-4][None] + (1 - hi) * latents
    latents = lo * selection[-7][None] + (1 - lo) * latents
    return ar.gaussian_filter(latents, 2, causal=0.2)


def get_noise(height, width, scale, num_scales, args):
    if width > 256:  # as the reference: leave the huge scales stochastic
        return None

    device = args.audio.device
    k1, k2 = keys.split(keys.PRNGKey(scale + 101))
    noisy = ar.gaussian_filter(keys.normal(k1, (args.n_frames, height, width), device=device), 5)
    calm = ar.gaussian_filter(keys.normal(k2, (args.n_frames, height, width), device=device), 64)

    mask = ar.circular_mask(height, width, radius=width / 2, soft=2, device=device)[None]
    lo = args.lo_onsets[:, None, None]
    hi = args.hi_onsets[:, None, None]

    noise = calm
    if width < 128:  # coarse scales: low onsets light up inside the disc
        noise = 2 * mask * lo * noisy + (1 - mask) * (1 - lo) * noise
    if width > 32:  # fine scales: high onsets light up outside the disc
        noise = 0.75 * (1 - mask) * hi * noisy + mask * (1 - 0.75 * hi) * noise

    return noise / (noise.std(correction=0) + 1e-8)
