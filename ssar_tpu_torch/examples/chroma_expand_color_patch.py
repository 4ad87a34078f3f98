"""Chroma-weighted palette with expanded tonal contrast on color layers.

Port of the JAX package's ``examples/chroma_expand_color_patch.py`` (the
tvgf idiom): ``chroma_weight_latents`` mixes a 12-latent palette by the
chromagram; ``ar.expand`` exaggerates the dominant pitch class before
mixing so key changes snap visibly; structure layers stay on a slow spline
loop, only layers 9+ take the tonal palette (``wrapping_slice`` keeps the
palette cycling when fewer than 12 latents are given).
"""
import torch

import ssar_tpu_torch.generate.audioreactive as ar


def initialize(args):
    ch = ar.chroma(args.audio, args.sr, args.n_frames)
    # exaggerate dominant pitch classes: expand each chroma bin above its median
    ch = torch.stack([ar.expand(ch[:, i], 0.5, 2.0) for i in range(ch.shape[1])], dim=1)
    args.chroma = ch / (ch.sum(dim=1, keepdim=True) + 1e-8)
    return args


def get_latents(selection, args):
    structure = ar.spline_loops(selection[:4], args.n_frames, 1, smoothing=12)
    palette = torch.stack([ar.wrapping_slice(selection, i, 1)[0] for i in range(12)])
    tonal = ar.chroma_weight_latents(args.chroma, palette)
    latents = structure.clone()
    latents[:, 9:] = tonal[:, 9:]
    return ar.gaussian_filter(latents, 1.5)
