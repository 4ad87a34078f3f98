"""Example patch: a DJ-mix tracklist drives per-section palettes and truncation.

Port of the JAX package's ``examples/tracklist_truncation_patch.py``: a
hand-written ``TRACKLIST`` of (start seconds, vibe) entries partitions the
mix; each track gets its own sub-palette and loop speed, crossfaded over a
one-phrase window, and ``get_truncation`` returns a per-frame psi: calm
"liquid" sections at full diversity (psi 1.0), aggressive "neuro" sections
pulled toward the mean latent (psi 0.6).  It covers ``get_truncation``.
"""
import numpy as np
import torch

import ssar_tpu_torch.generate.audioreactive as ar

# (start seconds, vibe); the last entry ends with the audio
TRACKLIST = [
    (0.0, "liquid"),
    (15.0, "neuro"),
    (30.0, "liquid"),
    (45.0, "neuro"),
]
VIBE_PSI = {"liquid": 1.0, "neuro": 0.6}
VIBE_LOOPS = {"liquid": 1.0, "neuro": 4.0}
TRANSITION_SEC = 2.0


def _section_frames(args):
    """[(start_frame, end_frame, vibe)] clipped to the rendered range."""
    starts = [s for s, _ in TRACKLIST] + [args.n_frames / args.fps]
    out = []
    for (s, vibe), e in zip(TRACKLIST, starts[1:]):
        f0, f1 = int(s * args.fps), min(int(e * args.fps), args.n_frames)
        if f1 > f0:
            out.append((f0, f1, vibe))
    return out


def initialize(args):
    args.sections = _section_frames(args)
    args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=150, clip=94, smooth=3, power=1)
    return args


def get_latents(selection, args):
    n_per = max(2, len(selection) // len(args.sections))
    latents = torch.zeros((args.n_frames,) + tuple(selection.shape[1:]), device=selection.device)
    for i, (f0, f1, vibe) in enumerate(args.sections):
        sub = selection[(i * n_per) % len(selection):][:n_per]
        loops = ar.slerp_loops(sub, f1 - f0, VIBE_LOOPS[vibe], smoothing=16 if vibe == "liquid" else 4)
        loops = ar.ModulatedLatents(0.4 * args.drum_onsets[f0:f1], loops, selection[-(i % 3) - 1])
        latents[f0:f1] = loops
    # one-phrase crossfade across section boundaries instead of hard cuts
    return ar.gaussian_filter(latents, TRANSITION_SEC * args.fps / 4)


def get_truncation(args):
    psi = np.ones(args.n_frames, np.float32)
    for f0, f1, vibe in args.sections:
        psi[f0:f1] = VIBE_PSI[vibe]
    # smooth the psi schedule
    return ar.gaussian_filter(torch.as_tensor(psi, device=args.audio.device), 12)
