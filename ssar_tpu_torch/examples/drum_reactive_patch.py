"""Example patch file: percussive-onset-modulated latents over a slerp loop.

Port of the JAX package's ``examples/drum_reactive_patch.py``: the
patch-file contract in its plainest form.  Render with::

    from ssar_tpu_torch.generate import audioreactive as ar
    mod = ar.load_patch_module("ssar_tpu_torch/examples/drum_reactive_patch.py")
    latents, noises = ar.render_patch(mod, audio, sr, palette=palette,
                                      synthesizer=syn, out_file="out.mp4")
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    # drum hits: percussive component -> clipped, smoothed onset envelope
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 3, causal=0)

    # slow build: long-window volume controls intro -> drop crossfade
    args.drop_weight = ar.volume(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    return args


def get_latents(selection, args):
    intro = ar.slerp_loops(selection[:4], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[4:8], args.n_frames, 2, smoothing=4)

    # drum hits punch a single accent latent into the intro section
    intro = ar.ModulatedLatents(0.5 * args.drum_onsets, intro, selection[8])

    w = args.drop_weight[:, None, None]
    latents = w * drop + (1 - w) * intro

    # keep color layers (12+) on a slow independent loop
    colors = ar.slerp_loops(selection[8:12], args.n_frames, 1, smoothing=4)
    latents[:, 12:] = colors[:, 12:]
    return ar.gaussian_filter(latents, 2.5)


def get_noise(height, width, scale, num_scales, args):
    device = args.audio.device
    key = keys.PRNGKey(scale)
    base = ar.gaussian_filter(keys.normal(key, (args.n_frames, height, width), device=device), 8)
    mod = keys.normal(keys.split(key)[1], (args.n_frames, height, width), device=device)
    return ar.ModulatedNoise(args.drum_onsets, base, mod)
