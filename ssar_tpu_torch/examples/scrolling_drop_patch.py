"""Animated-bend patch: endless scroll during the drop (tauceti idiom).

Port of the JAX package's ``examples/scrolling_drop_patch.py``: a
*time-varying* network bend, a horizontal translation of an inner feature
level whose offset ramps 0 -> W in loops during the drop, so the video
appears to scroll endlessly while the latents stay put.  Per-section color
latents own the layers above ``COLOR_LAYER``.

The bend dict carries a per-frame "modulation" (a tensor on the audio's
device), the render loop hands each batch its slice, and the transform
receives (x, mod).  The port's activations are NCHW, so the roll is along
dim 3 (W), one shift a sample, done as one gather.
"""
import torch

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys

COLOR_LAYER = 9
SCROLL_LEVEL = 2  # bend the 16 x 16 feature map: lower = more fluid


def initialize(args):
    args.kick = ar.compress(
        ar.onsets(args.audio, args.sr, args.n_frames, fmin=30, fmax=200, clip=95, smooth=1.5), 0.5, 0.5)
    # drop = the louder half of the clip (stand-in for hand-timed bounds);
    # the midpoint quantile is jnp.median's
    vol = ar.volume(args.audio, args.sr, args.n_frames, smooth=40)
    args.drop_mask = (vol > torch.quantile(vol, 0.5, interpolation="midpoint")).to(torch.float32)

    # scroll fraction: repeating 0 -> 1 ramps (6 s loops), frozen outside the drop
    loop = max(int(6 * args.fps), 2)
    ramp = (torch.arange(args.n_frames, device=vol.device) % loop) / loop
    args.scroll = ramp * args.drop_mask
    return args


def get_latents(selection, args):
    n = selection.shape[0]
    structure = ar.slerp_loops(selection[: max(n // 2, 2)], args.n_frames, 2, smoothing=8)
    structure = ar.ModulatedLatents(0.4 * args.kick, structure, selection[-1])
    colors = ar.slerp_loops(selection[n // 2:], args.n_frames, 1, smoothing=20)
    structure[:, COLOR_LAYER:] = colors[:, COLOR_LAYER:]
    return ar.gaussian_filter(structure, 1.5)


def scroll_shift(frac: torch.Tensor, width: int) -> torch.Tensor:
    """Each frame's roll in pixels: the fraction of the width, truncated."""
    return (frac * width).to(torch.int64)


def scroll(x, frac):
    """x (B, C, H, W), frac (B,) in [0, 1]: each sample rolled along W."""
    W = x.shape[3]
    src = torch.remainder(torch.arange(W, device=x.device) - scroll_shift(frac, W)[:, None], W)   # (B, W)
    return torch.gather(x, 3, src[:, None, None, :].expand_as(x))


def get_bends(args):
    return [{"layer": SCROLL_LEVEL, "transform": scroll, "modulation": args.scroll}]


def get_noise(height, width, scale, num_scales, args):
    if height > 64:
        return None
    base = ar.gaussian_filter(
        keys.normal(keys.PRNGKey(7 + scale), (args.n_frames, height, width), device=args.audio.device), 10)
    return base / (2.5 * base.std(correction=0))
