"""Example patch: the "Vret" redrocks set piece, a two-palette structure
pool and a color-loop stream that switches palette exactly at the drop,
with a deeper-than-usual color override (row 8, not 12).

Port of the JAX package's ``examples/redrocks_vret_patch.py`` (the
reference's 14_vret):
- ``structure = cat([colors, colors_drop] * 2)`` and a shuffle: intro and
  drop imagery drawn from a mixed pool;
- the color stream hard-switches to the drop palette at the drop frame;
- ``latents[:, 8:] = color_loops[:, 8:]``: the color palette also bends
  mid-level structure;
- a final ``gaussian_filter(latents, 3)``.
"""
import numpy as np
import torch

import ssar_tpu_torch.generate.audioreactive as ar

DROP_POS = 0.5


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 3, causal=0.1)
    args.focus_chroma = ar.chroma(args.audio, args.sr, args.n_frames).argmax(dim=1)
    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=2.5), 0.5, 0.5)
        * args.drop_weight)
    return args


def get_latents(selection, args):
    rng = np.random.RandomState(14)
    device = selection.device
    colors = selection[torch.as_tensor(rng.permutation(selection.shape[0]), device=device)][:6]
    colors_drop = selection[torch.as_tensor(rng.permutation(selection.shape[0]), device=device)][:6]

    structure = torch.cat([colors, colors_drop] * 2)
    structure = structure[torch.as_tensor(rng.permutation(structure.shape[0]), device=device)]

    half = structure.shape[0] // 2
    intro = ar.slerp_loops(structure[:half], args.n_frames, 0.5, smoothing=16)
    d = args.drum_onsets[:, None, None]
    intro = (1 - 0.5 * d) * intro + 0.5 * d * selection[rng.randint(selection.shape[0])][None]
    drop = ar.slerp_loops(structure[half:], args.n_frames, 2, smoothing=4)

    freqs = args.focus_chroma % structure.shape[0]
    reactive = ar.gaussian_filter(structure[freqs], 2)
    m = args.main_weight[:, None, None]
    drop = (1 - m) * drop + m * reactive

    w = args.drop_weight[:, None, None]
    latents = w * drop + (1 - w) * intro

    loops = ar.slerp_loops(colors, args.n_frames, 3, smoothing=16)
    loops_drop = ar.slerp_loops(colors_drop, args.n_frames, 1.5, smoothing=4)
    t = torch.arange(args.n_frames, device=device)[:, None, None]
    loops = torch.where(t >= int(DROP_POS * args.n_frames), loops_drop, loops)
    cut = max(latents.shape[1] // 2, 1)  # the reference's row 8 of 18
    latents[:, cut:] = loops[:, cut:]
    return ar.gaussian_filter(latents, 3)
