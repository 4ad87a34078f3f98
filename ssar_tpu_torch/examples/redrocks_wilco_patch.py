"""Example patch: the "Wilco Collab" redrocks set piece, a structure
sequence built by interleaving a pair of recurring anchor latents between
runs of a second palette, so the video keeps returning to its home imagery.

Port of the JAX package's ``examples/redrocks_wilco_patch.py`` (the
reference's 7_wilco):
- ``structure = cat((colors[[0,1]], more[[0,1,2]], colors[[0,1]],
  more[[3,4]], ...))``: anchors re-inserted every few rows;
- a very slow intro loop against a fast drop loop from the same split.
"""
import torch

import ssar_tpu_torch.generate.audioreactive as ar


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 3, causal=0.1)
    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=3), 0.5, 0.5)
        * args.drop_weight)
    return args


def get_latents(selection, args):
    anchors = selection[:2]          # the reference's colors[[0, 1]]
    rest = selection[2:]             # the reference's more_colors
    runs = []
    step = max(len(rest) // 4, 1)
    for i in range(0, len(rest), step):
        runs.append(anchors)
        runs.append(rest[i:i + step])
    structure = torch.cat(runs)

    half = structure.shape[0] // 2
    intro = ar.slerp_loops(structure[:half], args.n_frames, 0.5, smoothing=16)
    drop = ar.slerp_loops(structure[half:], args.n_frames, 4, smoothing=2)

    d = args.drum_onsets[:, None, None]
    intro = (1 - 0.5 * d) * intro + 0.5 * d * selection[0][None]

    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 2.5)
