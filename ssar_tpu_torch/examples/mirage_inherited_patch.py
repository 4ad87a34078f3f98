"""Inherited patch: override the shared base's latents (2_mirage idiom).

Port of the JAX package's ``examples/mirage_inherited_patch.py``: the
reference's 2_mirage does ``from .base import *`` and then replaces
``get_latents`` with a richer composite: chroma-argmax reactive latents
keyed into the palette, BPM-synced slerp loops for intro and drop, a random
choice between chroma-weighted and looped "sunset" color latents that own
only the color layers (14+), and the usual drop / intro crossfade.

The patch composes by loading the port's ``base_patch.py`` by path and
delegating: ``load_patch_module`` loads by path, so plain attribute reuse
replaces the reference's package-relative star import.
"""
import os

import numpy as np
import torch

import ssar_tpu_torch.generate.audioreactive as ar

_base = ar.load_patch_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "base_patch.py"))
get_noise = _base.get_noise  # inherit the layered noise hook unchanged


def initialize(args):
    args = _base.initialize(args)
    args.bpm = ar.tempo(args.audio, args.sr)
    return args


def get_latents(selection, args):
    n = selection.shape[0]
    duration = args.n_frames / args.fps
    loops_per = args.bpm / 60 * duration  # beats in the clip

    # sunset colors: random choice between chroma weighting and a slow loop
    sunset = selection[torch.as_tensor(np.random.RandomState(0).permutation(n), device=selection.device)]
    if np.random.RandomState(1).rand() < 0.5:
        sunset_latents = ar.chroma_weight_latents(ar.chroma(args.audio, args.sr, args.n_frames),
                                                  sunset[: min(12, n)])
    else:
        sunset_latents = ar.slerp_loops(sunset[: min(12, n)], args.n_frames, max(loops_per / 32, 1), smoothing=16)

    intro_latents = ar.slerp_loops(selection[: max(n // 2, 2)], args.n_frames, max(loops_per / 64, 1),
                                   smoothing=16)
    intro_latents = ar.ModulatedLatents(0.5 * args.drum_onsets, intro_latents,
                                        selection[int(np.random.RandomState(2).choice(n))])

    drop_latents = ar.slerp_loops(selection[max(n // 2, 2):], args.n_frames, max(loops_per / 16, 1), smoothing=4)
    # melody: focus pitch class keys directly into the palette
    reactive = ar.gaussian_filter(selection[args.focus_chroma % n], 2)
    mw = args.main_weight[:, None, None]
    drop_latents = (1 - mw) * drop_latents + mw * reactive

    w = args.drop_weight[:, None, None]
    latents = w * drop_latents + (1 - w) * intro_latents
    latents[:, 14:] = sunset_latents[:, 14:]
    return ar.gaussian_filter(latents, 2.5)
