"""Example patch: "Shella", chroma-weighted focus latents over a
hand-indexed spline-loop base, with a tiny additive-noise network bend on
the lowest synthesis block.

Port of the JAX package's ``examples/shella_patch.py`` (the reference's
shella):
- ``base = spline_loops(selection[[0,1,0,2,3,4,3,5,7,8,9,10]], ...)``:
  hand-picked repeat indices make the loop revisit home frames;
- ``latents = focus_onsets * chroma_weight_latents(...) + (1-...) * base``
  then ``gaussian_filter(3, causal=0.2)``;
- ``latents[:, 12:] = base[:, 12:]``: the base keeps the color layers;
- noise std normalised with a gain ``std * (1 + rand())`` drawn from
  ``np.random.RandomState(scale)`` (numpy, so the same everywhere);
- ``a_lil_noise = randn(1, 1, 4, 8)`` added to the 4 x 4 block: an
  ``AddNoise`` bend on layer 0 after a widening pad (NCHW).
"""
import numpy as np
import torch

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.focus_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=500, clip=95, smooth=3)
    args.focus_chroma = ar.chroma(args.audio, args.sr, args.n_frames)
    return args


def get_latents(selection, args):
    focus_latents = ar.chroma_weight_latents(args.focus_chroma, selection[:12])

    idx = torch.as_tensor(np.array([0, 1, 0, 2, 3, 4, 3, 5, 7, 8, 9, 10]) % selection.shape[0],
                          device=selection.device)
    base = ar.spline_loops(selection[idx], args.n_frames, 1)

    f = args.focus_onsets[:, None, None]
    latents = f * focus_latents + (1 - f) * base
    latents = ar.gaussian_filter(latents, 3, causal=0.2)

    cut = latents.shape[1] * 2 // 3  # the reference's layer 12
    latents[:, cut:] = base[:, cut:]
    return latents


def get_noise(height, width, scale, num_scales, args):
    if height > 128:
        return None
    device = args.audio.device
    k1, k2 = keys.split(keys.PRNGKey(99 + scale))
    # the layer-0 pad bend (get_bends) makes levels after the const block
    # render 2:1, and the noise fields follow (scale 0 is before the bend)
    shape = (args.n_frames, height, width if scale == 0 else 2 * width)
    noise = ar.gaussian_filter(keys.normal(k1, shape, device=device), 64)
    noiser = ar.gaussian_filter(keys.normal(k2, shape, device=device), 2)
    d = args.focus_onsets[:, None, None]
    noise = d * noiser + (1 - d) * noise
    gain = 1.0 + np.random.RandomState(scale).rand()
    return noise / (noise.std(correction=0) * gain)


def get_bends(args):
    a_lil_noise = 0.2 * keys.normal(keys.PRNGKey(4), (1, 1, 4, 8), device=args.audio.device)
    return [{"layer": 0, "transform": ar.sequential(ar.replication_pad(2, 2), ar.AddNoise(a_lil_noise))}]
