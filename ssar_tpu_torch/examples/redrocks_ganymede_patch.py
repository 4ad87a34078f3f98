"""Example patch: the "Ganymede" redrocks set piece, a hand-indexed and
shuffled structure palette, split half and half into intro and drop pools,
with drum hits pulling the intro toward a random accent latent.

Port of the JAX package's ``examples/redrocks_ganymede_patch.py`` (the
reference's 5_ganymede):
- structure latents chosen by an explicit index list, then permuted before
  the intro / drop split;
- ``intro = (1 - 0.5*drum) * slerp_loops(...) + 0.5*drum * selection[idx]``;
- beat-locked loop rates: ``n_loops = bpm / 60 * duration / 16``.
"""
import numpy as np
import torch

import ssar_tpu_torch.generate.audioreactive as ar


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=1, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 4, causal=0.1)

    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.bpm = ar.tempo(args.audio, args.sr)
    args.duration = args.n_frames / args.fps
    return args


def get_latents(selection, args):
    # a hand-picked index sequence (with repeats), then a shuffle
    idx = np.array([12, 1, 7, 2, 11, 3, 2, 5, 2, 7, 8, 9, 10, 11, 12]) % selection.shape[0]
    rng = np.random.RandomState(5)
    structure = selection[torch.as_tensor(rng.permutation(idx), device=selection.device)]

    half = structure.shape[0] // 2
    beats = max(args.bpm / 60.0 * args.duration / 16.0, 0.5)
    intro = ar.slerp_loops(structure[:half], args.n_frames, beats, smoothing=16)

    accent = selection[rng.randint(selection.shape[0])]
    d = args.drum_onsets[:, None, None]
    intro = (1 - 0.5 * d) * intro + 0.5 * d * accent[None]

    drop = ar.slerp_loops(structure[half:], args.n_frames, 4 * beats, smoothing=4)
    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 2)
