"""Per-file reactivity evaluation: both metrics of a video against its audio.

Counterpart of ``ssar_tpu/metrics/sectional.py``.  ``load_video`` decodes
with cv2 (imported when called; a machine without it can still evaluate
frames it has), and prepares the frames on the device with
``prepare_frames``: the same box-mean downsampling that cv2's INTER_AREA
does at an integer factor, then / 255 and NCHW.  Rendered frames that never
went through a file are prepared by the same function, so a card scores
them as it would score their decoded file.
"""
from __future__ import annotations

import torch

from ..utils.device import resolve_device


def prepare_frames(frames, downsample: int = 4, device=None) -> torch.Tensor:
    """(T, H, W, 3) uint8 RGB -> (T, 3, H / d, W / d) float32 in [0, 1] on
    `device` (the card unless ``device="cpu"``), d = `downsample`, which must
    divide H and W.  Each output pixel is cv2.resize's INTER_AREA value at
    that factor: the mean of its d x d box rounded to the nearest integer,
    halves to even (halves up at d = 2, cv2's vectorised path there)."""
    device = resolve_device(device)
    frames = torch.as_tensor(frames).to(device)
    if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"prepare_frames takes (T, H, W, 3) uint8 frames, got {tuple(frames.shape)} {frames.dtype}")
    T, H, W, _ = frames.shape
    d = int(downsample)
    if H % d or W % d:
        raise ValueError(f"downsample {d} must divide the frame size {H} x {W}")
    out = torch.empty(T, 3, H // d, W // d, dtype=torch.float32, device=device)
    # level / 255 divided on the host: a CUDA kernel multiplies by the reciprocal of a host scalar divisor,
    # one ulp off the reference's division
    levels = (torch.arange(256, dtype=torch.float32) / 255.0).to(device)
    area = d * d
    for s in range(0, T, 64):   # 64 frames at a time: the int32 box sums of a whole clip take 4x its bytes
        box = frames[s : s + 64].reshape(-1, H // d, d, W // d, d, 3).to(torch.int32).sum(dim=(2, 4))
        q, r = box // area, box % area
        up = (2 * r > area) | ((2 * r == area) & ((q % 2 == 1) | (d == 2)))
        out[s : s + 64] = levels[(q + up.to(torch.int32)).long()].permute(0, 3, 1, 2)
    return out


def load_video(path: str, downsample: int = 4, device=None):
    """mp4 -> ((T, 3, H, W) float32 in [0, 1] on `device`, fps).  Frames are
    decoded by cv2 on the host and prepared 64 at a time on the device;
    a size that `downsample` does not divide is resized by cv2 on the host."""
    import cv2
    import numpy as np

    device = resolve_device(device)
    cap = cv2.VideoCapture(str(path))
    fps = cap.get(cv2.CAP_PROP_FPS) or 24
    out, pending, factor = [], [], downsample
    while True:
        ok, frame = cap.read()
        if ok:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            h, w = frame.shape[:2]
            if downsample > 1 and (h % downsample or w % downsample):
                frame = cv2.resize(frame, (w // downsample, h // downsample), interpolation=cv2.INTER_AREA)
                factor = 1
            pending.append(frame)
        if pending and (not ok or len(pending) == 64):
            out.append(prepare_frames(np.stack(pending), factor, device))
            pending = []
        if not ok:
            break
    cap.release()
    return torch.cat(out), float(fps)


def evaluate_reactivity(audio, sr: int, video, fps: int, device=None) -> dict:
    """-> {"rhythmic": float, "chromatic": float} of `video` ((T, C, H, W) in
    [0, 1]) against `audio` ((L,) or (channels, L) at `sr`), on `device` (the
    card unless ``device="cpu"``)."""
    from .chroma import chromatic_reactivity
    from .rhythmic import rhythmic_reactivity

    device = resolve_device(device)
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device)   # one upload for both metrics
    video = torch.as_tensor(video, dtype=torch.float32).to(device)
    return {
        "rhythmic": float(rhythmic_reactivity(audio, sr, video, fps, device=device)),
        "chromatic": float(chromatic_reactivity(audio, sr, video, fps, device=device)),
    }


def evaluate_file(video_path: str, audio, sr: int, downsample: int = 4, device=None) -> dict:
    """``evaluate_reactivity`` of an mp4, decoded and downsampled by ``load_video``."""
    video, fps = load_video(video_path, downsample, device=device)
    return evaluate_reactivity(audio, sr, video, int(round(fps)), device=device)
