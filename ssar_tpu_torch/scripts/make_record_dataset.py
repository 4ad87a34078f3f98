"""Build the config-of-record training corpus for the paper grid on the port.

Counterpart of ``scripts/make_record_dataset.py``.  The reference's training
data is (track.wav, track.npy W+ targets, track_noise{4,8,16,32}.npy) per
track, made by random-patch renders (ssar/supervised/data.py:165-192).  This
reproduces that with no external assets: structured synthetic music (drums,
bass and chord sections), the random-patch system on its music information
for the latent and noise targets, the reference's corpus layout, then the
windowed training cache (``train.data.preprocess_directory``).

    python -m ssar_tpu_torch.scripts.make_record_dataset --out data/record --n_tracks 8

Runs on the CUDA device unless ``--device`` says otherwise.  The palette is
``StyleGAN2Mapper(seed=0)`` over 180 standard-normal z drawn from a CPU
``torch.Generator`` seeded 42 and moved to the device, so a seed gives the
same palette on every device.  The patches' noise banks are drawn from the
device's own generator (``generate/keys.py``), so the CPU's and a card's
noise targets differ; the tracks, the patch structures and the palette do
not.  The JAX package's corpus differs in both (its draws are
``jax.random``'s and its mapper's weights its own).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

FPS = 24
SR = 1024 * FPS


def synth_track(seed: int, seconds: int = 48) -> np.ndarray:
    """Structured synthetic music: 4 sections x (kick/snare/hat pattern +
    bass line + chord pad), per-seed bpm/key/progression so the music
    information has tempo, chroma and section structure to find.  The same
    numpy arithmetic as ``scripts/make_record_dataset.py:synth_track``,
    bit for bit."""
    rng = np.random.RandomState(seed)
    n = SR * seconds
    t = np.arange(n) / SR
    out = np.zeros(n, np.float32)

    bpm = rng.choice([96, 112, 124, 140])
    beat = 60.0 / bpm
    root = rng.choice([110.0, 123.47, 130.81, 146.83])  # A2, B2, C3, D3

    # four sections with different chord degrees and hat density
    section_len = seconds / 4
    degrees = rng.choice([0, 3, 5, 7, 8, 10], size=(4, 3))
    for s in range(4):
        sl = slice(int(s * section_len * SR), int((s + 1) * section_len * SR))
        ts = t[sl] - s * section_len
        # chord pad: three detuned partials per degree
        pad = np.zeros_like(ts)
        for d in degrees[s]:
            f = root * 2 ** (d / 12.0) * 2
            pad += np.sin(2 * np.pi * f * ts) + 0.5 * np.sin(2 * np.pi * f * 2.003 * ts)
        out[sl] += 0.08 * pad.astype(np.float32)
        # bass: eighth-note arpeggio over the section's degrees
        step = beat / 2
        idx = (ts / step).astype(int)
        f_b = root * 2 ** (degrees[s][idx % 3] / 12.0)
        env = np.exp(-4 * ((ts % step) / step))
        out[sl] += (0.25 * env * np.sin(2 * np.pi * f_b * ts)).astype(np.float32)

    # drums, whole track
    phase = t % beat
    kick_env = np.exp(-30 * phase) * (np.sin(2 * np.pi * (55 + 120 * np.exp(-40 * phase)) * phase))
    out += 0.6 * kick_env.astype(np.float32)
    snare_phase = (t - beat) % (2 * beat)
    snare = np.exp(-25 * snare_phase) * rng.randn(n) * 0.5
    out += 0.3 * snare.astype(np.float32)
    hat_phase = t % (beat / 2)
    hats = np.exp(-90 * hat_phase) * rng.randn(n)
    out += 0.12 * hats.astype(np.float32)

    out += 0.01 * rng.randn(n).astype(np.float32)
    return (0.8 * out / np.abs(out).max()).astype(np.float32)


def make_targets(audio: np.ndarray, seed: int, palette: torch.Tensor) -> tuple:
    """Random-patch targets for one track, on the palette's device: latents
    (T, n_ws, 512) and the noise pyramids at 4/8/16/32 (the levels the
    reactor predicts; ``NOISE_SIZES`` indices 0, 1, 3, 5), as float32 numpy."""
    from ..generate import mir
    from ..generate.patch import Patch

    with torch.no_grad():
        features, segmentations, tempo = mir.retrieve_music_information(audio, SR, device=palette.device)
        patch = Patch(features=features, segmentations=segmentations, tempo=tempo, seed=seed, fps=FPS)
        latents, noise_modules = patch.forward(palette)
        T = latents.shape[0]
        noises = [noise_modules[i].forward(0, T).float().cpu().numpy() for i in (0, 1, 3, 5)]
    return latents.float().cpu().numpy(), noises


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/record")
    ap.add_argument("--n_tracks", type=int, default=8)
    ap.add_argument("--seconds", type=int, default=48)
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from scipy.io import wavfile

    from ..gan.wrapper import StyleGAN2Mapper
    from ..train.data import preprocess_directory

    corpus = Path(args.out) / "corpus"
    cache = Path(args.out) / "cache"
    corpus.mkdir(parents=True, exist_ok=True)

    mapper = StyleGAN2Mapper(seed=0, device=args.device)
    palette = mapper(torch.randn(180, 512, generator=torch.Generator().manual_seed(42)))
    del mapper

    for i in range(args.n_tracks):
        stem = corpus / f"track{i:02d}"
        if (stem.with_suffix(".npy")).exists():
            print(f"{stem.name}: exists, skipping")
            continue
        t0 = time.perf_counter()
        audio = synth_track(seed=1000 + i, seconds=args.seconds)
        latents, noises = make_targets(audio, seed=1000 + i, palette=palette)
        wavfile.write(stem.with_suffix(".wav"), SR, audio)
        np.save(stem.with_suffix(".npy"), latents)
        for s, nz in zip((4, 8, 16, 32), noises):
            np.save(f"{stem}_noise{s}.npy", nz)
        print(f"{stem.name}: T={latents.shape[0]} latents {latents.shape} ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    t0 = time.perf_counter()
    meta = preprocess_directory(str(corpus), str(cache), dur=8, fps=FPS, device=palette.device)
    n_train = np.load(cache / "train_features.npy", mmap_mode="r").shape[0]
    n_val = np.load(cache / "val_features.npy", mmap_mode="r").shape[0]
    print(f"cache ready: {n_train} train / {n_val} val windows "
          f"(split {meta['train']} | {meta['val']}) in {time.perf_counter() - t0:.1f} s")
    return meta


if __name__ == "__main__":
    main()
