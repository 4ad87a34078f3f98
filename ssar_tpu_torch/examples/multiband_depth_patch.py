"""Per-band envelopes steering separate W+ depth bands.

Port of the JAX package's ``examples/multiband_depth_patch.py`` (the cbc_*
live-set idiom): low / mid / high band energy each modulates a different
depth band of the W+ stack; lows move structure (layers 0-6), mids move
texture (6-12), highs flicker color (12-18).
"""
import ssar_tpu_torch.generate.audioreactive as ar


def initialize(args):
    args.low = ar.rms(args.audio, args.sr, args.n_frames, fmax=100, smooth=6)
    args.mid = ar.onsets(args.audio, args.sr, args.n_frames, fmin=400, fmax=2000, clip=95, smooth=3)
    args.high = ar.onsets(args.audio, args.sr, args.n_frames, fmin=4000, clip=97, smooth=1.5)
    args.high = ar.expand(args.high, 0.5, 2.0)
    return args


def get_latents(selection, args):
    structure = ar.slerp_loops(selection[:4], args.n_frames, 0.5, smoothing=16)
    texture = ar.slerp_loops(selection[4:8], args.n_frames, 2, smoothing=6)
    color = ar.slerp_loops(selection[8:12], args.n_frames, 4, smoothing=3)

    accent = selection[-1][None]
    lo = args.low[:, None, None]
    mi = args.mid[:, None, None]
    hi = args.high[:, None, None]

    latents = structure.clone()
    latents[:, 0:6] = ((1 - 0.6 * lo) * structure + 0.6 * lo * accent)[:, 0:6]
    latents[:, 6:12] = ((1 - 0.5 * mi) * texture + 0.5 * mi * accent)[:, 6:12]
    latents[:, 12:18] = ((1 - 0.4 * hi) * color + 0.4 * hi * accent)[:, 12:18]
    return ar.gaussian_filter(latents, 1.0)
