"""Perlin-flow noise pyramid with chroma-keyed texture.

Port of the JAX package's ``examples/perlin_tonal_noise_patch.py``: fractal
perlin noise (a normal lattice resized by the Keys cubic) as the slow base
field, and a chroma-weighted mix of per-pitch noise keyframes on top
(``TonalNoise``), so harmony changes re-texture the frame while the perlin
field keeps drifting.  It covers the cubic resize and ``TonalNoise``.
"""
import torch

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.chroma = ar.chroma(args.audio, args.sr, args.n_frames)
    args.flow = ar.rms(args.audio, args.sr, args.n_frames, smooth=20)
    return args


def get_latents(selection, args):
    base = ar.gaussian_loops(selection[:6], args.n_frames, 1.5, smoothing=8)
    # one palette latent per chroma bin (cycled if fewer than 12 given)
    palette12 = torch.stack([selection[i % len(selection)] for i in range(12)])
    tonal = ar.TonalLatents(args.chroma, palette12)
    w = 0.35 * args.flow[:, None, None]
    return (1 - w) * base + w * tonal


def get_noise(height, width, scale, num_scales, args):
    if height > 128:
        return None
    key = keys.PRNGKey(100 + scale)
    base = ar.perlin_noise(key, (args.n_frames, height, width), (4, max(height // 8, 1), max(width // 8, 1)),
                           octaves=2, device=args.audio.device)
    tonal = ar.TonalNoise(keys.split(key)[1], args.chroma, (height, width))
    out = base + 0.5 * args.flow[:, None, None] * tonal
    return out / (out.std(correction=0) + 1e-8)
