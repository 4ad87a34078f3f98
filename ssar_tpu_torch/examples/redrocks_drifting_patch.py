"""Example patch: the "Drifting" redrocks set piece, a six-section
tracklist, early-track damping, a tiled-palette fallback when no structure
file matches, and a mid-track color-palette switch.

Port of the JAX package's ``examples/redrocks_drifting_patch.py`` (the
reference's 8_drifting):
- six named sections, here as track fractions;
- the first stretch of every envelope is damped (``* 0.666``) so the intro
  stays subdued;
- the shuffled-tile fallback ``cat([selection]*4)[perm]`` for a missing
  structure file;
- a second color set takes over the color layers mid-track.
"""
import numpy as np
import torch

import ssar_tpu_torch.generate.audioreactive as ar

SECTIONS = [0.0, 0.15, 0.4, 0.55, 0.62, 0.8, 1.0]  # intro/1st/2nd/build/3rd/outro


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=1, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 2, causal=0)
    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=2.5), 0.5, 0.5)
        * args.drop_weight)
    args.low_noise_mod = ar.normalize((1 - args.drop_weight) * args.main_weight)

    # damp everything until the first movement lands
    early = torch.arange(args.n_frames, device=args.audio.device) < int(SECTIONS[1] * args.n_frames)
    for name in ("drum_onsets", "drop_weight", "main_weight", "low_noise_mod"):
        setattr(args, name, torch.where(early, getattr(args, name) * 0.666, getattr(args, name)))
    return args


def get_latents(selection, args):
    rng = np.random.RandomState(8)
    # structure-file-missing fallback: tile the palette 4x and shuffle
    structure = torch.cat([selection] * 4)
    structure = structure[torch.as_tensor(rng.permutation(structure.shape[0]), device=selection.device)]

    half = structure.shape[0] // 2
    intro = ar.slerp_loops(structure[:half], args.n_frames, 0.5, smoothing=16)
    drop = ar.slerp_loops(structure[half:], args.n_frames, 2, smoothing=4)

    d = args.drum_onsets[:, None, None]
    intro = (1 - 0.5 * d) * intro + 0.5 * d * selection[rng.randint(selection.shape[0])][None]

    w = args.drop_weight[:, None, None]
    latents = w * drop + (1 - w) * intro

    # color layers: palette A for the first movements, palette B afterwards
    colors_a = ar.slerp_loops(selection[: selection.shape[0] // 2], args.n_frames, 2, smoothing=16)
    colors_b = ar.slerp_loops(selection[selection.shape[0] // 2:], args.n_frames, 2, smoothing=16)
    switch = torch.arange(args.n_frames, device=selection.device)[:, None, None] >= int(SECTIONS[3] * args.n_frames)
    colors = torch.where(switch, colors_b, colors_a)
    cut = latents.shape[1] * 2 // 3
    latents[:, cut:] = colors[:, cut:]
    return ar.gaussian_filter(latents, 2)
