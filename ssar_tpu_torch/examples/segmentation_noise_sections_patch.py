"""Music-structure segmentation switching the noise character per section.

Port of the JAX package's ``examples/segmentation_noise_sections_patch.py``:
the Laplacian segmentation (``ar.laplacian_segmentation``) selects, per
section, one of several noise velocity fields (quiet sections drift, loud
ones boil) while the latents ride one continuous loop; ``percentile_clip``
keeps the section energy envelope tame.  It covers
``laplacian_segmentation``.
"""
import torch
import torch.nn.functional as F

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.sections = ar.laplacian_segmentation(args.audio, args.sr, args.n_frames, ks=(4,))[:, 0]
    energy = ar.rms(args.audio, args.sr, args.n_frames, smooth=10)
    args.energy = ar.percentile_clip(energy, 95)
    return args


def get_latents(selection, args):
    return ar.spline_loops(selection[:6], args.n_frames, 1, smoothing=10)


def get_noise(height, width, scale, num_scales, args):
    if height > 64:
        return None
    ks = keys.split(keys.PRNGKey(scale), 4)
    sigmas = [24.0, 12.0, 5.0, 1.5]  # per-section drift -> boil
    fields = torch.stack([
        ar.gaussian_filter(keys.normal(k, (args.n_frames, height, width), device=args.audio.device), s)
        for k, s in zip(ks, sigmas)
    ])  # (4, T, H, W)
    onehot = F.one_hot(args.sections.long(), 4).T[:, :, None, None].float()  # (4, T, 1, 1)
    out = (onehot * fields).sum(dim=0)
    out = out * (0.5 + args.energy[:, None, None])
    return out / (out.std(correction=0) + 1e-8)
