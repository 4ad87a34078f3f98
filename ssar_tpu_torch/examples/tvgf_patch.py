"""Example patch: "TVGF", band-split drum onsets (low / high at 150 Hz)
driving separate accent latents, a chroma-weighted base, and per-scale
onset-gated noise with a per-scale output gain.

Port of the JAX package's ``examples/tvgf_patch.py`` (the reference's tvgf):
- ``lo_onsets = onsets(drums, fmax=150)`` / ``hi_onsets = onsets(drums,
  fmin=150)``: one stem, two bands;
- ``latents = hi*sel[-4] + lo*sel[-7] + bass*sel[-5] + chroma base``, then
  ``gaussian_filter(4, causal=0.2)``;
- noise smoothness 64 / 7 / 2: bass gates the mid, hi gates the fine only
  for ``width > 8``;
- ``noise /= noise.std() * (0.85 + rand())``, the gain drawn from
  ``np.random.RandomState(scale)``.

The noise keys start from ``hash("tvgf")``, as the original's: Python
salts ``str`` hashes per process (``PYTHONHASHSEED``), so the noise is the
same within a process and differs between processes.

Stems (``<track>/drums.wav``, ``<track>/bass.wav``) are read when present,
each envelope at its stem's own sample rate; the mix otherwise.
"""
import os

import numpy as np

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def _stem(args, name):
    if not args.audio_file:
        return None
    path = os.path.join(os.path.splitext(args.audio_file)[0], f"{name}.wav")
    if not os.path.exists(path):
        return None
    audio, sr, _ = ar.load_audio(path, device=args.audio.device)
    return audio, sr


def initialize(args):
    drums = _stem(args, "drums")
    daudio, dsr = drums if drums is not None else (args.audio, args.sr)
    args.lo_onsets = ar.onsets(daudio, dsr, args.n_frames, fmax=150, clip=96, smooth=3)
    args.hi_onsets = ar.onsets(daudio, dsr, args.n_frames, fmin=150, clip=96, smooth=3)

    bass = _stem(args, "bass")
    baudio, bsr = bass if bass is not None else (args.audio, args.sr)
    args.bass_onsets = ar.rms(baudio, bsr, args.n_frames, smooth=4, clip=99, power=1)
    return args


def get_latents(selection, args):
    chroma = ar.chroma(args.audio, args.sr, args.n_frames)
    latents = ar.gaussian_filter(ar.chroma_weight_latents(chroma, selection[:12]), 4)

    lo = args.lo_onsets[:, None, None]
    hi = args.hi_onsets[:, None, None]
    bass = args.bass_onsets[:, None, None]
    latents = hi * selection[-4][None] + (1 - hi) * latents
    latents = lo * selection[-7][None] + (1 - lo) * latents
    latents = bass * selection[-5][None] + (1 - bass) * latents
    return ar.gaussian_filter(latents, 4, causal=0.2)


def get_noise(height, width, scale, num_scales, args):
    device = args.audio.device
    k1, k2, k3 = keys.split(keys.PRNGKey(hash("tvgf") % 2**31 + scale), 3)
    shape = (args.n_frames, height, width)
    noise = ar.gaussian_filter(keys.normal(k1, shape, device=device), 64)
    noisy = ar.gaussian_filter(keys.normal(k2, shape, device=device), 7)
    noiser = ar.gaussian_filter(keys.normal(k3, shape, device=device), 2)

    bass = args.bass_onsets[:, None, None]
    noise = bass * noisy + (1 - bass) * noise
    if width > 8:
        hi = args.hi_onsets[:, None, None]
        noise = hi * noiser + (1 - hi) * noise
    gain = 0.85 + np.random.RandomState(scale).rand()
    return noise / (noise.std(correction=0) * gain)
