"""Example patch file: Laplacian-segmentation scene switching.

Port of the JAX package's ``examples/section_scene_switch.py``: each
musical section (found by the Laplacian segmentation) gets its own latent
"scene", a slow slerp loop through a section-specific palette slice.  Scene
changes crossfade over about half a second; within a scene, onsets punch an
accent latent on the structure layers only.

Render with::

    from ssar_tpu_torch.generate import audioreactive as ar
    mod = ar.load_patch_module("ssar_tpu_torch/examples/section_scene_switch.py")
    latents, noises = ar.render_patch(mod, audio, sr, palette=palette,
                                      synthesizer=syn, out_file="out.mp4")
"""
import torch
import torch.nn.functional as F

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    # K = 4 section labels per frame (hard labels of the CQT segmentation),
    # one-hot and crossfaded for latent mixing
    labels = ar.laplacian_segmentation(args.audio, args.sr, args.n_frames, ks=(4,))[:, 0]
    onehot = F.one_hot(labels, 4).to(torch.float32)                   # (T, 4)
    args.scene_weights = ar.gaussian_filter(onehot, args.fps / 48)   # ~0.5 s fade
    args.scene_weights = args.scene_weights / (args.scene_weights.sum(dim=1, keepdim=True) + 1e-8)

    args.onsets = ar.onsets(args.audio, args.sr, args.n_frames, clip=95, smooth=2)
    args.onsets = ar.compress(args.onsets, 0.5, 0.5)
    return args


def get_latents(selection, args):
    # one slow loop per scene over a disjoint palette slice
    scenes = [ar.slerp_loops(selection[2 * k: 2 * k + 3], args.n_frames, 1, smoothing=12) for k in range(4)]
    latents = sum(args.scene_weights[:, k, None, None] * scenes[k] for k in range(4))

    # onsets punch an accent latent into the coarse-structure layers
    accent = ar.ModulatedLatents(0.6 * args.onsets, latents, selection[8])
    n_struct = min(6, latents.shape[1])
    latents[:, :n_struct] = accent[:, :n_struct]
    return ar.gaussian_filter(latents, 1.5)


def get_noise(height, width, scale, num_scales, args):
    # scene changes also swap the noise texture
    device = args.audio.device
    key = keys.PRNGKey(scale)
    banks = keys.normal(key, (4, height, width), device=device)
    base = torch.einsum("Tk,khw->Thw", args.scene_weights, banks)
    flicker = keys.normal(keys.split(key)[1], (args.n_frames, height, width), device=device)
    return ar.ModulatedNoise(0.5 * args.onsets, base, flicker)
