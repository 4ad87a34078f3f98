"""Per-track palettes over a live-set tracklist (cbc_* idiom).

Port of the JAX package's ``examples/tracklist_palettes_patch.py``: every
track of the set gets its own latent palette and loop style, bar-quantized
to the track's BPM: track k slerps through palette slice k for ``n_bars``
bars a loop, and tracks crossfade at their boundaries.  Boundaries are
fractions of the clip so it renders on any input; for a real set use
absolute seconds.
"""
import torch

import ssar_tpu_torch.generate.audioreactive as ar

# (start fraction, bars per loop, smoothing) per track
TRACKS = [
    (0.00, 4, 12),
    (0.35, 2, 6),
    (0.70, 1, 3),
]
XFADE_S = 0.25  # crossfade length in seconds


def initialize(args):
    args.bpm = ar.tempo(args.audio, args.sr)
    args.kick = ar.compress(
        ar.onsets(args.audio, args.sr, args.n_frames, fmin=30, fmax=200, clip=95, smooth=1.5), 0.5, 0.5)
    return args


def get_latents(selection, args):
    n = selection.shape[0]
    per = max(n // len(TRACKS), 2)
    dur = args.n_frames / args.fps
    beats_per_bar = 4.0
    device = selection.device
    f = torch.arange(args.n_frames, dtype=torch.float32, device=device)

    latents = torch.zeros((args.n_frames, selection.shape[1], selection.shape[2]), device=device)
    weight_sum = torch.zeros((args.n_frames, 1, 1), device=device)
    for k, (frac, bars, smooth) in enumerate(TRACKS):
        start = frac * dur
        end = TRACKS[k + 1][0] * dur if k + 1 < len(TRACKS) else dur
        # bar-quantized loop count for this track's section
        sec_beats = args.bpm / 60.0 * (end - start)
        n_loops = max(sec_beats / (beats_per_bar * bars), 1.0)
        pal = selection[k * per:(k + 1) * per + 1]
        track_lat = ar.slerp_loops(pal, args.n_frames, n_loops, smoothing=smooth)
        # smooth boundary window (crossfade at both edges)
        ramp = XFADE_S * args.fps
        w = torch.clamp((f - start * args.fps) / ramp, 0, 1) * torch.clamp((end * args.fps - f) / ramp, 0, 1)
        latents = latents + w[:, None, None] * track_lat
        weight_sum = weight_sum + w[:, None, None]
    latents = latents / torch.clamp(weight_sum, min=1e-4)
    latents = ar.ModulatedLatents(0.4 * args.kick, latents, selection[-1])
    return ar.gaussian_filter(latents, 1.5)
