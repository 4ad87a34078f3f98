"""Example patch file: bar-synced loops and lazy noise-module algebra.

Port of the JAX package's ``examples/tempo_loop_noise_patch.py``: latents
slerp through the palette once every N bars, and each layer's noise is an
expression tree of looped banks blended and modulated by envelopes
(``generate/noise.py``), returned as a module: the render loop evaluates it
per chunk, so a whole track's full-size noise video never exists in memory.
It covers lazy ``Noise`` trees.

Render with::

    from ssar_tpu_torch.generate import audioreactive as ar
    mod = ar.load_patch_module("ssar_tpu_torch/examples/tempo_loop_noise_patch.py")
    latents, noises = ar.render_patch(mod, audio, sr, palette=palette,
                                      synthesizer=syn, out_file="out.mp4")
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.generate.noise import Blend, Loop, Modulate, ScaleBias


def initialize(args):
    args.bpm = ar.tempo(args.audio, args.sr)
    args.kick = ar.compress(
        ar.onsets(args.audio, args.sr, args.n_frames, fmin=30, fmax=200, clip=95, smooth=1.5), 0.5, 0.5)
    args.air = ar.gaussian_filter(ar.rms(args.audio, args.sr, args.n_frames, smooth=20), 5)
    return args


def get_latents(selection, args):
    # one pass through the palette every 4 bars, kick-punched toward an anchor
    base = ar.TempoLoopLatents(args.bpm, selection, args.n_frames, n_bars=4, fps=args.fps)
    k = args.kick[:, None, None]
    return (1 - 0.5 * k) * base + 0.5 * k * selection[:1]


def get_noise(height, width, scale, num_scales, args):
    k1, k2 = keys.split(keys.PRNGKey(100 + scale))
    # a looping bank (one cycle per 2 bars) blended by the air envelope, then
    # kick-modulated between the two
    frames_per_bar = args.fps * 4 * 60.0 / float(args.bpm)
    n_loops = max(args.n_frames / max(2 * frames_per_bar, 1e-6), 1e-3)
    loop = Loop(k1, args.n_frames, (height, width), n_loops=n_loops, device=args.audio.device)
    blend = Blend(k2, args.n_frames, (height, width), modulator=args.air[:, None])
    mixed = Modulate(loop, blend, args.kick[:, None])
    # quiet the lowest scales so structure stays readable
    gain = 0.5 if scale < 2 else 1.0
    return ScaleBias(mixed, scale=gain, bias=0.0)
