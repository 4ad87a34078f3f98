"""Feature-space bend: replication pad + additive noise at an early layer.

Port of the JAX package's ``examples/addnoise_bend_patch.py`` (the kelp
idiom): widen the 4 x 4 trunk features 2:1 with replication padding and
disguise the repetition with a fixed additive noise texture, composed with
``ar.sequential``.  The port's bends see NCHW activations, so the texture
is NCHW (1, 1, 4, 8).
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.groove = ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=95, smooth=3), 0.5, 0.5)
    return args


def get_latents(selection, args):
    base = ar.spline_loops(selection[:5], args.n_frames, 1, smoothing=12)
    return ar.ModulatedLatents(0.4 * args.groove, base, selection[5])


def get_bends(args):
    texture = 0.025 * keys.normal(keys.PRNGKey(7), (1, 1, 4, 8), device=args.audio.device)
    transform = ar.sequential(ar.replication_pad(left=2, right=2), ar.AddNoise(texture))
    return [{"layer": 0, "transform": transform}]
