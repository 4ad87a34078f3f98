"""Example patch file: network bending, a widescreen render with reactive bends.

Port of the JAX package's ``examples/widescreen_bend_patch.py``: a
replication pad on the 4 x 4 constant block makes every later level render
at 2:1, and an ``AddNoise`` bend textures the early features (the
reference's ``Sequential(ReplicationPad2d, AddNoise)`` idiom).  The port's
bends see NCHW activations, so the noise field is NCHW (1, 1, 4, 8) and the
pad takes the last two axes.  It covers ``get_bends``, ``replication_pad``
and ``sequential``.

With the level-0 pad the output is (H, 2H): give the synthesizer no
``output_size`` (native), and let the generator use its own noise (this
patch has no ``get_noise``).
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    # one smooth and one percussive envelope from the mix
    args.kick = ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=95, smooth=2), 0.5, 0.5)
    args.swell = ar.gaussian_filter(ar.rms(args.audio, args.sr, args.n_frames, smooth=50), 10)
    return args


def get_latents(selection, args):
    # slow slerp loop through the palette, punched toward one anchor on kicks
    base = ar.slerp_loops(selection, args.n_frames, n_loops=2, smoothing=12)
    anchor = selection[:1]
    k = args.kick[:, None, None]
    return (1 - 0.6 * k) * base + 0.6 * k * anchor


def get_bends(args):
    # widescreen: pad the 4x4 const block to 4x8 (2:1 output), then texture
    # the padded block with a fixed noise field
    noise = 0.025 * keys.normal(keys.PRNGKey(0), (1, 1, 4, 8), device=args.audio.device)
    widescreen = ar.sequential(ar.replication_pad(2, 2), ar.AddNoise(noise))
    return [{"layer": 0, "transform": widescreen}]
