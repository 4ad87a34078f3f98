"""Example patch: the "Tension Coil" redrocks set piece, a hard-timed drop
frame with pre-drop envelope attenuation and a post-drop boost window.

Port of the JAX package's ``examples/redrocks_tensioncoil_patch.py`` (the
reference's 6_tensioncoil):
- a global drop frame computed from the tracklist;
- everything before the drop is scaled down so the intro simmers;
- the 500 frames after the drop get ``drop_weight /= 0.35`` and then a
  clamp to 1: an over-unity hit that saturates the crossfade;
- a hand-picked ``color`` row owns the color layers after the drop.
"""
import torch

import ssar_tpu_torch.generate.audioreactive as ar

# fraction of the track at which the drop lands (the reference hardcodes
# seconds from the mix's tracklist)
DROP_POS = 0.45


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 2, causal=0.25)

    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=66, clip=66) ** 2
    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=2.5), 0.5, 0.5)
        * args.drop_weight)
    args.low_noise_mod = ar.normalize((1 - args.drop_weight) * args.main_weight)

    drop_frame = int(DROP_POS * args.n_frames)
    t = torch.arange(args.n_frames, device=args.audio.device)
    pre = t < max(drop_frame - int(args.fps), 0)       # up to 1 s before the drop
    boost = (t >= drop_frame) & (t < drop_frame + 500)  # the reference's 500-frame hit

    args.drum_onsets = torch.where(pre, args.drum_onsets * 0.333, args.drum_onsets)
    args.main_weight = torch.where(pre, args.main_weight * 0.333, args.main_weight)
    args.low_noise_mod = torch.where(pre, args.low_noise_mod * 0.6, args.low_noise_mod)
    dw = torch.where(pre, args.drop_weight * 0.6, args.drop_weight)
    dw = torch.where(boost, dw / 0.35, dw)
    args.drop_weight = torch.clamp(dw, 0.0, 1.0)
    args.drop_frame = drop_frame
    return args


def get_latents(selection, args):
    # the reference keeps a separate hand-picked color row (colors[[2]])
    color = selection[2 % selection.shape[0]][None]
    half = selection.shape[0] // 2
    intro = ar.slerp_loops(selection[:half], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[half:], args.n_frames, 4, smoothing=1)

    d = args.drum_onsets[:, None, None]
    drop = (1 - 0.4 * d) * drop + 0.4 * d * color

    w = args.drop_weight[:, None, None]
    latents = w * drop + (1 - w) * intro
    # color layers ride the hand-picked row after the drop
    t = torch.arange(args.n_frames, device=selection.device)[:, None, None]
    cut = latents.shape[1] * 2 // 3
    colored = latents.clone()
    colored[:, cut:] = color[:, cut:]
    latents = torch.where(t >= args.drop_frame, colored, latents)
    return ar.gaussian_filter(latents, 2)
