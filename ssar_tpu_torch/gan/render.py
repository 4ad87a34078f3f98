"""Render loop: device synthesis overlapped with host encode.

Counterpart of ``ssar_tpu/gan/render.py``.  Frames are synthesised in
batches, packed to I420 on the device (1.5 bytes per pixel across the
device-to-host link instead of 3), and double-buffered: on the card, batch
j + 1 is queued on the caller's CUDA stream, with its copy into a pinned
host buffer, while the host waits for batch j's copy and hands it to the
frame writer.  The last batch is padded by repeating the last frame.

Over several ranks (``parallel.mesh.get_mesh``) each padded batch is split
over the data axis: every rank synthesises its rows, and rank 0 gathers the
frames, converts, fetches and writes them; the other ranks write nothing.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..parallel.mesh import axis_rank, get_mesh, shard_batch
from ..utils.profiling import span
from .video_io import VideoWriter


def rgb_to_i420(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) float RGB in [0, 1] -> (B, H*3//2, W) uint8 I420.

    Studio-range BT.601 with 2x2-mean chroma subsampling, the layout and
    matrix cv2's COLOR_YUV2BGR_I420 decodes.  Needs H % 4 == 0 and W % 2 == 0.
    """
    B, H, W, _ = frames.shape
    x = torch.clamp(frames, 0.0, 1.0) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b

    def sub(c):
        return c.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))

    r2, g2, b2 = sub(r), sub(g), sub(b)
    u = 128.0 - 0.148223 * r2 - 0.290993 * g2 + 0.439216 * b2
    v = 128.0 + 0.439216 * r2 - 0.367788 * g2 - 0.071427 * b2
    yq = (y + 0.5).to(torch.uint8)
    u_rows = (u + 0.5).to(torch.uint8).reshape(B, H // 4, W)
    v_rows = (v + 0.5).to(torch.uint8).reshape(B, H // 4, W)
    return torch.cat([yq, u_rows, v_rows], dim=1)


def _pad_batch(x: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Repeat the last frame so every batch has one shape (trimmed after fetch)."""
    if x.shape[0] < batch_size:
        x = torch.cat([x, x[-1:].expand(batch_size - x.shape[0], *x.shape[1:])])
    return x


@torch.no_grad()
def render_latents_to_video(synthesizer, latents, noises: Sequence | None, out_file: str | None = None,
                            fps: float = 24, output_size: tuple[int, int] | None = None,
                            batch_size: int = 8, audio_file: str | None = None, audio_offset: float = 0,
                            audio_duration: float | None = None, postprocess_fn: Callable | None = None,
                            progress: bool = True, transfer: str = "auto", writer=None,
                            stats: dict | None = None):
    """Render a (T, n_ws, 512) latent sequence (+ per-layer noise, None
    entries allowed) through `writer`.

    Each noise entry is a (T, 1, H, W) sequence, or a callable ``n(i, b)``
    that returns the (b, H, W) noise of frames [i, i + b) only (a lazy noise,
    so a whole track's full-size noise never exists in memory).
    `postprocess_fn` maps each batch of (B, H, W, 3) frames in [0, 1]
    before they are clipped and quantised.  When the synthesizer has animated
    bends, each batch passes its frame numbers (``frame_idx``).  ``transfer``
    "i420" packs frames to I420 on the device (1.5 bytes a pixel over the
    link), "rgb" fetches uint8 RGB, "auto" takes I420 where the output size
    allows it (H % 4 == 0, W % 2 == 0).  `progress` shows a tqdm bar where
    tqdm imports.

    `writer` is a context manager with ``write_i420(frame)`` for (H*3//2, W)
    uint8 frames and ``write(frame)`` for (H, W, 3) uint8 frames; the default
    is a ``VideoWriter`` on `out_file`.  Returns the writer.  When `stats` is
    a dict, the loop's seconds (the ``render.loop`` span, the writer's enter
    to its exit) are added to ``stats["render_s"]``.

    Over several ranks every rank calls this with the same arguments; each
    synthesises its rows of a batch (its frames of lazy noises and animated
    bends included) and rank 0 alone writes.  Other ranks return their
    `writer` unused.
    """
    device = synthesizer.device
    latents = torch.as_tensor(latents, dtype=torch.float32).to(device)
    T = latents.shape[0]
    if output_size is None:
        output_size = (synthesizer.config.resolution, synthesizer.config.resolution)
    w_, h_ = int(output_size[0]), int(output_size[1])
    if transfer == "auto":
        transfer = "i420" if h_ % 4 == 0 and w_ % 2 == 0 else "rgb"
    if noises is not None:
        noises = [n if n is None or callable(n) else torch.as_tensor(n).to(device, synthesizer.dtype)
                  for n in noises]
    mesh = get_mesh(device=device)
    main = mesh.size() == 1 or dist.get_rank() == 0

    def batch_noise(n, i, b, lo):
        """Noise `n` of this rank's `b` rows, frames [lo, lo + b) of the padded batch."""
        if n is None:
            return None
        if isinstance(n, torch.Tensor):
            return shard_batch(_pad_batch(n[i : i + batch_size], batch_size), mesh).permute(0, 2, 3, 1)
        # rows past the track repeat its last frame, as the padded batch does
        window = torch.as_tensor(n(min(lo, T - 1), max(min(b, T - lo), 1))).to(device, synthesizer.dtype)
        return _pad_batch(window, b)[..., None]

    def synth(i):
        """Batch i's frames in [-1, 1], gathered on rank 0; on other ranks, None."""
        lat = shard_batch(_pad_batch(latents[i : i + batch_size], batch_size), mesh)
        b = lat.shape[0]
        lo = i + (axis_rank(mesh, "data") * b if b < batch_size else 0)
        kw = {}
        if noises is not None:
            with span("render.noise"):
                kw["noises"] = [batch_noise(n, i, b, lo) for n in noises]
        if getattr(synthesizer, "bend_mods", None):
            kw["frame_idx"] = shard_batch(torch.arange(i, i + batch_size).clamp(max=T - 1), mesh)
        with span("render.synthesis"):
            frames = synthesizer(lat, **kw)
        if b < batch_size:
            parts = [torch.empty_like(frames) for _ in range(batch_size // b)] if main else None
            dist.gather(frames.contiguous(), parts, dst=0)
            if not main:
                return None
            frames = torch.cat(parts)
        elif not main:
            return None
        return frames

    def convert(frames):
        """Frames in [-1, 1] -> the uint8 frames the writer takes."""
        frames = (frames + 1.0) / 2.0
        if postprocess_fn is not None:
            frames = postprocess_fn(frames)
        if transfer == "i420" and tuple(frames.shape[1:3]) == (h_, w_):
            return rgb_to_i420(frames)
        return (torch.clamp(frames, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    starts = list(range(0, T, batch_size))
    if not main:
        with span("render.loop", stats, "render_s"):
            for i in starts:
                synth(i)
        return writer
    if writer is None:
        writer = VideoWriter(out_file, output_size, fps=fps, audio_file=audio_file,
                             audio_offset=audio_offset, audio_duration=audio_duration)
    cuda = device.type == "cuda"
    if cuda:
        stream = torch.cuda.current_stream(device)
        host = [None, None]   # pinned buffers, allocated at the first batch's shape
        done = [None, None]

    def launch(j):
        """Queue batch j on the caller's stream; on the card, its fetch into
        pinned host buffer j % 2."""
        frames = synth(starts[j])
        with span("render.transfer"):
            out = convert(frames)
            if not cuda:
                return out
            slot = j % 2
            if host[slot] is None:
                host[slot] = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host[slot].copy_(out, non_blocking=True)
            done[slot] = torch.cuda.Event()
            done[slot].record(stream)
        return slot

    def fetch(token):
        with span("render.wait"):
            if not cuda:
                return token.numpy()
            done[token].synchronize()
            return host[token].numpy()

    batches = range(len(starts))
    if progress:
        try:
            from tqdm import tqdm

            batches = tqdm(batches, unit_scale=batch_size, desc="render")
        except ImportError:
            pass

    with span("render.loop", stats, "render_s"), writer as video:
        pending = launch(0) if starts else None
        for j in batches:
            nxt = launch(j + 1) if j + 1 < len(starts) else None
            # batch j + 1 never reuses batch j's buffer: slots alternate, and
            # batch j + 2 is only queued after batch j has been written
            frames = fetch(pending)
            with span("render.write"):
                for f in frames[: min(batch_size, T - starts[j])]:
                    video.write_i420(f) if f.ndim == 2 else video.write(f)
            pending = nxt
    return writer
