"""Example patch: "Reflex Angle", the cross-patch reuse idiom (this patch
takes its ``get_bends`` from a sibling patch file) plus the classic
triple-smoothness noise stack gated by combined drum and transient energy.

Port of the JAX package's ``examples/reflexangle_patch.py`` (the
reference's 3_reflexangle):
- ``from .base import get_bends``: patches share hooks by importing them
  from other patch modules; here ``ar.load_patch_module`` on the port's
  ``widescreen_bend_patch.py``;
- ``low_noise_mod = 0.75 * normalize((1 - drop) * main)``;
- noise fields at smoothness 20 / 5 / 1.5 with the blend
  ``onsets = (drum_onsets + main_weight) / 2`` gating the noisiest.
"""
import os

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys

# cross-patch reuse: the widescreen AddNoise bend of the sibling patch
_sibling = ar.load_patch_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "widescreen_bend_patch.py"))


def initialize(args):
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=200, clip=94, smooth=2, power=1)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)
    args.drum_onsets = ar.gaussian_filter(args.drum_onsets, 3, causal=0.1)
    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    args.main_weight = (
        ar.compress(ar.onsets(args.audio, args.sr, args.n_frames, clip=97, smooth=3), 0.5, 0.5)
        * args.drop_weight)
    args.low_noise_mod = 0.75 * ar.normalize((1 - args.drop_weight) * args.main_weight)
    # the sibling's initialize attaches the envelopes it reads
    args = _sibling.initialize(args)
    return args


def get_latents(selection, args):
    half = selection.shape[0] // 2
    intro = ar.slerp_loops(selection[:half], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[half:], args.n_frames, 2, smoothing=2)
    d = args.drum_onsets[:, None, None]
    intro = (1 - 0.5 * d) * intro + 0.5 * d * selection[1][None]
    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 2)


def get_noise(height, width, scale, num_scales, args):
    if height > 128:
        return None
    device = args.audio.device
    k1, k2, k3 = keys.split(keys.PRNGKey(3 + scale), 3)
    # the sibling's layer-0 pad bend makes every level after the const block
    # render 2:1, so later noise fields are double width (scale 0 is added in
    # the 4 x 4 const conv, before the bend, and stays square)
    shape = (args.n_frames, height, width if scale == 0 else 2 * width)
    noise = ar.gaussian_filter(keys.normal(k1, shape, device=device), 20)
    noisy = ar.gaussian_filter(keys.normal(k2, shape, device=device), 5)
    noisier = ar.gaussian_filter(keys.normal(k3, shape, device=device), 1.5)

    lo = args.low_noise_mod[:, None, None]
    noise = lo * noisy + (1 - lo) * noise
    if width > 16:
        onsets = ((args.drum_onsets + args.main_weight) / 2)[:, None, None]
        noise = onsets * noisier + (1 - onsets) * noise
    return noise / noise.std(correction=0)


def get_bends(args):
    return _sibling.get_bends(args)
