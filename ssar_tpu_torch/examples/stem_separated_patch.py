"""Example patch file: per-stem reactivity (drums / bass / melodic stems).

Port of the JAX package's ``examples/stem_separated_patch.py``: split the
track into source-separated stems and drive different aspects of the video
from each:

- ``drums.wav``  -> sharp onset envelope -> latent punches + noise flicker
- ``bass.wav``   -> slow compressed onsets -> structure crossfade
- ``other.wav``  -> chroma argmax -> pitch-keyed palette selection

Stems are expected next to the audio file (``mytrack/drums.wav`` etc., the
demucs / spleeter convention), each envelope at its stem's own sample rate;
when absent the patch falls back to band-filtered envelopes of the mix so
it still renders standalone.

Render with::

    from ssar_tpu_torch.generate import audioreactive as ar
    mod = ar.load_patch_module("ssar_tpu_torch/examples/stem_separated_patch.py")
    latents, noises = ar.render_patch(mod, audio, sr, palette=palette,
                                      audio_file="mytrack.wav",
                                      synthesizer=syn, out_file="out.mp4")
"""
import os

import ssar_tpu_torch.generate.audioreactive as ar
from ssar_tpu_torch.generate import keys


def _stem(args, name):
    """Load ``<track>/<name>.wav`` if present, else None."""
    if not args.audio_file:
        return None
    stem_dir = os.path.splitext(args.audio_file)[0]
    path = os.path.join(stem_dir, f"{name}.wav")
    if not os.path.exists(path):
        return None
    audio, sr, _ = ar.load_audio(path, device=args.audio.device)
    return audio, sr


def initialize(args):
    drums = _stem(args, "drums")
    if drums is not None:
        args.drum_onsets = ar.onsets(drums[0], drums[1], args.n_frames, clip=95, smooth=2)
    else:  # fallback: the high-passed mix approximates the kit
        args.drum_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=2000, clip=95, smooth=2)
    args.drum_onsets = ar.compress(args.drum_onsets, 0.5, 0.5)

    bass = _stem(args, "bass")
    if bass is not None:
        args.bass_onsets = ar.onsets(bass[0], bass[1], args.n_frames, smooth=4)
    else:
        args.bass_onsets = ar.rms(args.audio, args.sr, args.n_frames, fmax=150, smooth=4)
    args.bass_onsets = ar.gaussian_filter(args.bass_onsets, 1.5)

    other = _stem(args, "other")
    melodic, msr = other if other is not None else (args.audio, args.sr)
    args.focus_chroma = ar.chroma(melodic, msr, args.n_frames).argmax(dim=1)

    # long-window loudness ** 2 marks the drop sections
    args.drop_weight = ar.rms(args.audio, args.sr, args.n_frames, smooth=100) ** 2
    return args


def get_latents(selection, args):
    intro = ar.slerp_loops(selection[:4], args.n_frames, 1, smoothing=16)
    drop = ar.slerp_loops(selection[4:8], args.n_frames, 2, smoothing=4)

    # melodic stem: the chroma class indexes the palette, smoothed into a
    # pitch-keyed trajectory (the reference's focus_chroma idiom)
    keyed = selection[args.focus_chroma % selection.shape[0]]
    keyed = ar.gaussian_filter(keyed, 2)
    drop = ar.ModulatedLatents(args.bass_onsets, drop, keyed)

    # drums punch one accent latent into whichever section is active
    intro = ar.ModulatedLatents(0.5 * args.drum_onsets, intro, selection[8])

    w = args.drop_weight[:, None, None]
    return ar.gaussian_filter(w * drop + (1 - w) * intro, 2.5)


def get_noise(height, width, scale, num_scales, args):
    device = args.audio.device
    key = keys.PRNGKey(scale)
    base = ar.perlin_noise(key, (args.n_frames, height, width),
                           (4, max(height // 8, 1), max(width // 8, 1)), octaves=2, device=device)
    flicker = keys.normal(keys.split(key)[1], (args.n_frames, height, width), device=device)
    # drums flicker the fine scales harder than the coarse ones
    amount = args.drum_onsets * (scale + 1) / num_scales
    return ar.ModulatedNoise(amount, base, flicker)
