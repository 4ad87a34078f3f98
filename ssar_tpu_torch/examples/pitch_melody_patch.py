"""Example patch file: pitch-tracked melody reactivity.

Port of the JAX package's ``examples/pitch_melody_patch.py``: the
predominant pitch class (piptrack) steers a continuous trajectory through
the palette (melody up = palette forward), while the bass band pumps a slow
noise swell.  It covers ``pitch_track``, ``PitchTrackLatents``,
``TempoLoopLatents`` and ``perlin_noise``.
"""
import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def initialize(args):
    args.pitch = ar.pitch_track(args.audio, args.sr, args.n_frames, smooth=6)
    args.bass = ar.rms(args.audio, args.sr, args.n_frames, fmax=150, smooth=8, power=2)
    args.tempo_bpm = ar.tempo(args.audio, args.sr)
    return args


def get_latents(selection, args):
    # melody: pitch class interpolates through the palette ring
    melody = ar.PitchTrackLatents(args.pitch, selection, smoothing=4)

    # bed: a tempo-locked loop so motion persists through quiet passages
    bed = ar.TempoLoopLatents(args.tempo_bpm, selection[:6], args.n_frames, fps=args.fps, n_bars=8,
                              type="spline", smooth=8)

    # bass loudness crossfades bed -> melody (the drop follows the melody)
    w = args.bass[:, None, None]
    latents = (1 - 0.7 * w) * bed + 0.7 * w * melody
    return ar.gaussian_filter(latents, 2)


def get_noise(height, width, scale, num_scales, args):
    device = args.audio.device
    key = keys.PRNGKey(100 + scale)
    calm = ar.perlin_noise(key, (args.n_frames, height, width),
                           (2, max(height // 16, 1), max(width // 16, 1)), octaves=2, device=device)
    storm = keys.normal(keys.split(key)[1], (args.n_frames, height, width), device=device)
    # bass swells push the fine scales toward white noise
    amount = args.bass * scale / max(num_scales - 1, 1)
    return ar.ModulatedNoise(amount, calm, storm)
