"""Timed-section patch: second-based DROP/BREAK constants (16_corrupt idiom).

Port of the JAX package's ``examples/timed_drops_patch.py``: live-set
patches hard-code their tracklist as wall-clock constants and branch the
dynamics on them.  Section boundaries are given in seconds, turned once
into smooth frame masks, with different latent and noise behaviour a
section.  Sections here are fractions of the clip so the example renders on
any input; for a real set replace them with absolute times minus the
offset.
"""
import torch

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys

# tracklist (seconds, relative to render offset): edit these per set
INTRO_END = 0.5
DROP1_END = 1.2
BREAK_END = 1.6


def _section_mask(args, start_s, end_s, ramp=3):
    """Smooth 0/1 frame mask for [start_s, end_s) with a short ramp."""
    f = torch.arange(args.n_frames, device=args.audio.device)
    m = ((f >= start_s * args.fps) & (f < end_s * args.fps)).to(torch.float32)
    return ar.gaussian_filter(m, ramp)


def initialize(args):
    dur = args.n_frames / args.fps
    scale = dur / 2.0  # example timings assume a 2 s demo clip
    args.intro_m = _section_mask(args, 0, INTRO_END * scale)
    args.drop1_m = _section_mask(args, INTRO_END * scale, DROP1_END * scale)
    args.break_m = _section_mask(args, DROP1_END * scale, BREAK_END * scale)
    args.drop2_m = _section_mask(args, BREAK_END * scale, dur)
    args.kick = ar.compress(
        ar.onsets(args.audio, args.sr, args.n_frames, fmin=30, fmax=220, clip=95, smooth=1.5), 0.5, 0.5)
    return args


def get_latents(selection, args):
    n = selection.shape[0]
    q = max(n // 4, 1)
    intro = ar.slerp_loops(selection[:q + 1], args.n_frames, 1, smoothing=16)
    drop1 = ar.slerp_loops(selection[q:2 * q + 1], args.n_frames, 4, smoothing=3)
    brk = ar.slerp_loops(selection[2 * q:3 * q + 1], args.n_frames, 1, smoothing=24)
    drop2 = ar.ModulatedLatents(0.6 * args.kick,
                                ar.slerp_loops(selection[3 * q:], args.n_frames, 6, smoothing=2), selection[0])

    def m(x):
        return x[:, None, None]

    latents = (m(args.intro_m) * intro + m(args.drop1_m) * drop1
               + m(args.break_m) * brk + m(args.drop2_m) * drop2)
    return ar.gaussian_filter(latents, 1.5)


def get_noise(height, width, scale, num_scales, args):
    if height > 128:
        return None
    device = args.audio.device
    key = keys.PRNGKey(100 + scale)
    calm = ar.gaussian_filter(keys.normal(key, (args.n_frames, height, width), device=device), 12)
    wild = keys.normal(keys.split(key)[1], (args.n_frames, height, width), device=device)
    drops = torch.clamp(args.drop1_m + args.drop2_m, 0, 1)[:, None, None]
    amp = (0.5 + drops) * (1 + args.kick[:, None, None])
    noise = calm * (1 - drops) + wild * drops * 0.5
    return amp * noise / (2.5 * noise.std(correction=0))
