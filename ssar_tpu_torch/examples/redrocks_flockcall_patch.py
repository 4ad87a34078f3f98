"""Example patch: the "Flock Call" redrocks set piece, the canonical full
redrocks skeleton: shuffled color palette, chroma-argmax-indexed reactive
structure latents blended in by transient energy, and an independent slow
color-layer loop overriding the top W+ rows.

Port of the JAX package's ``examples/redrocks_flockcall_patch.py`` (the
reference's 9_flockcall):
- ``colors = selection[permutation]``;
- ``freqs = focus_chroma % len(structure); reactive = structure[freqs]``,
  then ``gaussian_filter(reactive, 2)``: the pitch class picks the imagery;
- ``drop = (1-main)*drop + main*reactive``;
- ``latents[:, 12:] = color_loops[:, 12:]``: the color override.
"""
import numpy as np
import torch

import ssar_tpu_torch.generate.audioreactive as ar


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 3, causal=0.25)
    args.focus_chroma = ar.chroma(args.audio, args.sr, args.n_frames).argmax(dim=1)
    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=2.5), 0.5, 0.5)
        * args.drop_weight)
    args.low_noise_mod = ar.normalize((1 - args.drop_weight) * args.main_weight)
    return args


def get_latents(selection, args):
    rng = np.random.RandomState(9)
    colors = selection[torch.as_tensor(rng.permutation(selection.shape[0]), device=selection.device)]
    structure = selection

    half = structure.shape[0] // 2
    intro = ar.slerp_loops(structure[:half], args.n_frames, 0.75, smoothing=16)
    d = args.drum_onsets[:, None, None]
    intro = (1 - 0.5 * d) * intro + 0.5 * d * selection[rng.randint(selection.shape[0])][None]

    drop = ar.slerp_loops(structure[half:], args.n_frames, 3, smoothing=6)

    freqs = args.focus_chroma % structure.shape[0]
    reactive = ar.gaussian_filter(structure[freqs], 2)
    m = args.main_weight[:, None, None]
    drop = (1 - m) * drop + m * reactive

    w = args.drop_weight[:, None, None]
    latents = w * drop + (1 - w) * intro

    color_loops = ar.slerp_loops(colors, args.n_frames, 3, smoothing=16)
    cut = latents.shape[1] * 2 // 3  # the reference's row 12 of 18
    latents[:, cut:] = color_loops[:, cut:]
    return ar.gaussian_filter(latents, 2.5)
