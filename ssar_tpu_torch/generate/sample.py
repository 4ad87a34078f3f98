"""CLI: random-patch audio-reactive music video (``python -m ssar_tpu_torch.generate.sample``).

Counterpart of ``ssar_tpu/generate/sample.py``: load audio -> music
information (``mir.py``) -> seeded ``Patch`` -> StyleGAN2 palette -> render
in chunks with the noise trees evaluated lazily per chunk -> video.  Chunks
overlap at the end instead of going ragged; frames are packed to I420 on the
device where the size allows it; one chunk is in flight on the card while
the host writes the previous one.  The noise trees run eagerly, chunk by
chunk (the JAX package traces them with synthesis into one program).

``--smoke`` renders a short clip of synthetic audio with a random 64 px
generator, so the whole path runs without any assets.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..gan.render import rgb_to_i420
from ..gan.stylegan2 import StyleGAN2Config
from ..gan.video_io import VideoWriter
from ..gan.wrapper import StyleGAN2
from ..ops.resample import resample
from ..train.data import load_audio as load_audio_file
from ..utils.device import full_precision, resolve_device
from . import keys
from .mir import retrieve_music_information
from .patch import Patch


def load_audio(audio_file: str, offset: float, duration: float | None, fps: float, device=None):
    """Mono waveform resampled to 1024 * fps (on `device`, the CPU when None),
    as numpy, and that rate."""
    audio, sr = load_audio_file(audio_file)
    audio = audio[int(offset * sr):]
    if duration is not None:
        audio = audio[: int(duration * sr)]
    new_sr = int(1024 * fps)
    with torch.no_grad(), full_precision():
        audio = resample(torch.as_tensor(np.asarray(audio, np.float32)).to(device or "cpu"), int(sr), new_sr,
                         lowpass_filter_width=6)
    return audio.cpu().numpy(), new_sr


def chunk_starts(T: int, bs: int) -> list[int]:
    """Chunk starts of `bs` frames over T frames; the last chunk overlaps
    the one before it instead of going ragged (none when T == 0)."""
    if T == 0:
        return []
    starts = list(range(0, T - bs + 1, bs))
    if starts and starts[-1] != T - bs:
        starts.append(T - bs)
    return starts


def generate(audio_file: str | None = None, patch_file: str | None = None, seed: int | None = None,
             latent_seeds: str | None = None, fps: float = 24, audio_offset: float = 0,
             audio_duration: float | None = None, downscale_factor: float = 4,
             aspect_ratio: float = 1, batch_size: int = 16, model_file: str | None = None,
             out_dir: str = "output", config: StyleGAN2Config | None = None,
             audio: np.ndarray | None = None, sr: int | None = None, writer=None, device=None,
             stats: dict | None = None):
    """Render a random-patch video of `audio_file` (or of `audio` at `sr`);
    returns the output path.  `writer` is a frame writer with ``write_i420``
    / ``write`` (default: a ``VideoWriter`` on the output path); the patch's
    JSON is written beside the output path either way.  Runs on the CUDA
    device unless `device` says otherwise.  When
    `stats` is a dict, stage seconds ("load_s", "mir_features_s",
    "mir_segmentation_s", "model_s": the generator and its palette,
    "patch_s": ``Patch.forward``, "render_s"), the frame count and the bytes
    of the noise banks the render uses ("bank_bytes") are written into it."""
    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    stats = {} if stats is None else stats
    if seed is None:
        seed = int(np.random.randint(0, 2**31))
    config = config or StyleGAN2Config()

    out_size = (round(aspect_ratio * config.resolution / downscale_factor),
                round(config.resolution / downscale_factor))
    stem = Path(audio_file).stem if audio_file else "synthetic"
    out_file = f"{out_dir}/{stem}_RandomPatches_seed{seed}_{out_size[0]}x{out_size[1]}.mp4"

    t0 = time.perf_counter()
    if audio is None:
        audio, sr = load_audio(audio_file, audio_offset, audio_duration, fps, device=device)
    stats["load_s"] = time.perf_counter() - t0

    print("extracting information from audio...")
    seconds = {}
    features, segmentations, tempo = retrieve_music_information(audio, sr, device=device, seconds=seconds)
    stats["mir_features_s"], stats["mir_segmentation_s"] = seconds["features"], seconds["segmentation"]

    if patch_file is None:
        patch = Patch(features=features, segmentations=segmentations, tempo=tempo, seed=seed, fps=fps)
    else:
        patch = Patch.load(patch_file, features=features, segmentations=segmentations, tempo=tempo, fps=fps)
    print(patch)

    t0 = time.perf_counter()
    G = StyleGAN2(model_file=model_file, output_size=out_size, config=config, seed=seed, device=device)
    if latent_seeds is None:
        latent_palette = G.mapper(keys.normal(keys.PRNGKey(seed), (180, 512), device=device))
    else:
        latent_palette = G.get_w_latents(latent_seeds)
    sync()
    stats["model_s"] = time.perf_counter() - t0

    print("preparing latent and noise sequences...")
    t0 = time.perf_counter()
    # The synthesizer stops at the nearest power of two >= the output size
    # and resizes; the patch's noise modules are made on that (square) grid
    # and aligned by spatial scale: rendering 256 px from a 1024 px model,
    # the 4..256 layers take the banks whose downscaled size matches, entries
    # offset by 2 log2(d), as the JAX package does.
    n_used = G.synthesizer.n_noises_used
    d_synth = max(config.resolution // G.synthesizer.synth_res, 1)
    with torch.no_grad():
        latents, noise = patch.forward(latent_palette, downscale_factor=d_synth, aspect_ratio=1)
    offset = 2 * int(round(np.log2(d_synth)))
    noise = noise[offset : offset + n_used]
    sync()
    stats["patch_s"] = time.perf_counter() - t0
    stats["bank_bytes"] = sum(_bank_bytes(n) for n in noise)

    print("rendering...")
    T = latents.shape[0]
    bs = min(batch_size, T)
    i420 = out_size[1] % 4 == 0 and out_size[0] % 2 == 0

    @torch.no_grad()
    def render_chunk(s: int) -> torch.Tensor:
        ns = [nm(s, bs)[..., None] for nm in noise]   # (bs, H, W, 1)
        frames = torch.clamp((G.synthesizer(latents[s : s + bs], noises=ns) + 1) / 2, 0, 1)
        if i420 and tuple(frames.shape[1:3]) == (out_size[1], out_size[0]):
            return rgb_to_i420(frames)
        return (frames * 255.0 + 0.5).to(torch.uint8)

    cuda = device.type == "cuda"
    pinned: list = [None, None]

    def launch(j: int, s: int):
        """Queue chunk j; on the card, its copy into pinned buffer j % 2."""
        out = render_chunk(s)
        if not cuda:
            return out.numpy()
        if pinned[j % 2] is None:
            pinned[j % 2] = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        pinned[j % 2].copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return pinned[j % 2], done

    def fetch(token) -> np.ndarray:
        if not cuda:
            return token
        host, done = token
        done.synchronize()
        return host.numpy()

    starts = chunk_starts(T, bs)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    patch.save(out_file.replace(".mp4", ".json"))
    if writer is None:
        writer = VideoWriter(output_file=out_file, output_size=out_size, fps=fps, audio_file=audio_file,
                             audio_offset=audio_offset, audio_duration=audio_duration)
    t0 = time.perf_counter()
    written = 0
    with writer as video:
        pending, pending_start = None, 0
        for j, s in enumerate(starts + [None]):
            # chunk j is queued before chunk j - 1 is fetched; buffers alternate,
            # and chunk j + 1 is queued only after chunk j - 1 has been written
            nxt = None if s is None else launch(j, s)
            if pending is not None:
                frames = fetch(pending)
                for f in frames[written - pending_start:]:   # skip the overlap already written
                    video.write_i420(f) if f.ndim == 2 else video.write(f)
                    written += 1
            pending, pending_start = nxt, (s or 0)
    stats["render_s"] = time.perf_counter() - t0
    stats["frames"] = written
    print(f"wrote {out_file}")
    return out_file


def _bank_bytes(module) -> int:
    """Bytes of the noise banks a noise tree holds on its device."""
    own = module.noise.numel() * module.noise.element_size() if hasattr(module, "noise") else 0
    return own + sum(_bank_bytes(getattr(module, f)) for f in ("left", "right", "base") if hasattr(module, f))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_file", type=str, default=None)
    p.add_argument("--patch_file", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--latent_seeds", type=str, default=None)
    p.add_argument("--fps", type=float, default=24)
    p.add_argument("--audio_offset", type=float, default=0)
    p.add_argument("--audio_duration", type=float, default=None)
    p.add_argument("--downscale_factor", type=float, default=4)
    p.add_argument("--aspect_ratio", type=float, default=1)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--model_file", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="output")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file; explicit CLI flags override it")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    if args.config:
        from ..utils.config import apply_config_file

        args = apply_config_file(p, args, args.config, argv)

    if args.smoke:
        fps, secs = 12, 4
        sr = int(1024 * fps)
        t = np.arange(sr * secs) / sr
        audio = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 330 * t)
                 + 0.05 * np.random.RandomState(0).randn(len(t))).astype(np.float32)
        audio[:: sr // 2] += 1.0
        cfg = StyleGAN2Config(resolution=64)
        return generate(seed=args.seed or 42, fps=fps, downscale_factor=1, batch_size=8,
                        config=cfg, audio=audio, sr=sr, out_dir=args.out_dir, device=args.device)
    return generate(audio_file=args.audio_file, patch_file=args.patch_file, seed=args.seed,
                    latent_seeds=args.latent_seeds, fps=args.fps, audio_offset=args.audio_offset,
                    audio_duration=args.audio_duration, downscale_factor=args.downscale_factor,
                    aspect_ratio=args.aspect_ratio, batch_size=args.batch_size,
                    model_file=args.model_file, out_dir=args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
