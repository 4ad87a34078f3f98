"""Video features: histograms, spatial spectra, band RMS, absdiff, optical
flow and directograms.

Counterpart of ``ssar_tpu/video/features.py``.  Videos are (T, C, H, W)
float32 in [0, 1]; every function is plain PyTorch on the video's device
(the optical flow convolves with TF32 off, ``video/flow.py``).  On the card
two of them run the hand kernels: ``absdiff`` the framewise absdiff (B2,
``ops/absdiff.py``) and ``directogram`` its two 3-tap median filters (B1,
``ops/median.py``).

- Histograms follow ``torch.histc``'s range (each row's own [min, max]) with
  the reference's bin arithmetic, floor((x - lo) / max(hi - lo, 1e-12) *
  bins) in float32, the upper edge in the last bin, counted for all rows at
  once (``torch.histc`` rounds the bin differently at the edges).
- The log-polar warp of the spatial spectrum is a bilinear gather whose
  indices and weights are built once per size on the host.
- Quantiles go through ``ops/quantile.py`` (``torch.quantile`` refuses more
  than 2**24 values; a 256 px clip of 1440 frames has 70.8 M).
- Optical flow is the port's Farneback (``video/flow.py``), run over
  frame pairs in chunks (the same function, less memory); ``backend="cv2"``
  is OpenCV's on the host, imported only when asked for.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..audio.processing import normalize, onset_envelope, spectral_flux, standardize
from ..ops.absdiff import absdiff as _absdiff
from ..ops.median import median_filter
from ..ops.quantile import quantiles

# frame pairs per Farneback call: at most this many pixels of the first frames
FLOW_CHUNK_PIXELS = 1 << 25


# ------------------------------------------------------------ histograms --
def _histc_rows(x: torch.Tensor, bins: int) -> torch.Tensor:
    """(N, M) -> (N, bins) float32: each row's histogram over its own [min, max]."""
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    scaled = (x - lo) / torch.clamp(hi - lo, min=1e-12) * bins
    idx = torch.clamp(torch.floor(scaled), 0, bins - 1).long()
    idx = idx + torch.arange(x.shape[0], device=x.device)[:, None] * bins
    counts = torch.bincount(idx.reshape(-1), minlength=x.shape[0] * bins)
    return counts.reshape(x.shape[0], bins).to(torch.float32)


def _histc(x: torch.Tensor, bins: int) -> torch.Tensor:
    """``torch.histc``'s range semantics: all of x over [x.min(), x.max()],
    values on the upper edge in the last bin.  (bins,) float32."""
    return _histc_rows(x.reshape(1, -1), bins)[0]


def _channel_histogram(frames: torch.Tensor, bins: int) -> torch.Tensor:
    """(T, H, W) -> (T, bins), each row divided by its maximum."""
    hist = _histc_rows(frames.reshape(frames.shape[0], -1), bins)
    return hist / hist.amax(dim=1, keepdim=True)


def redogram(video: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _channel_histogram(video[:, 0], bins)


def greenogram(video: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _channel_histogram(video[:, 1], bins)


def blueogram(video: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _channel_histogram(video[:, 2], bins)


def rgb_hist(video: torch.Tensor, bins: int = 96) -> torch.Tensor:
    b = bins // 3
    return torch.cat([redogram(video, b), greenogram(video, b), blueogram(video, b)], dim=-1)


def rgb_to_hsv(video: torch.Tensor) -> torch.Tensor:
    """(T, 3, H, W) RGB in [0, 1] -> HSV, hue in [0, 2 pi] (kornia's convention)."""
    r, g, b = video[:, 0], video[:, 1], video[:, 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=video.dtype, device=video.device)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    hr = torch.remainder((g - b) / safe, 6.0)
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
    h = torch.where(delta == 0, zero, h) * (np.pi / 3)
    return torch.stack([h, s, v], dim=1)


def huestogram(video: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _channel_histogram(rgb_to_hsv(video)[:, 0], bins)


def saturogram(video: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _channel_histogram(rgb_to_hsv(video)[:, 1], bins)


def valueogram(video: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _channel_histogram(rgb_to_hsv(video)[:, 2], bins)


def hsv_hist(video: torch.Tensor, bins: int = 96) -> torch.Tensor:
    b = bins // 3
    hsv = rgb_to_hsv(video)
    return torch.cat([_channel_histogram(hsv[:, c], b) for c in range(3)], dim=-1)


# ----------------------------------------------------- variance / motion --
def visual_variance(video: torch.Tensor) -> torch.Tensor:
    """(T, 1): each frame's variance (ddof 0)."""
    return video.var(dim=(1, 2, 3), correction=0)[:, None]


def absdiff(video: torch.Tensor, stride: int = 64) -> torch.Tensor:
    """(T, ...) -> (T, 1) framewise sum of |frame[t+1] - frame[t]| (`stride`
    is taken for the reference's call surface)."""
    return _absdiff(video)[:, None]


# -------------------------------------------------- spatial spectrogram --
@lru_cache(maxsize=8)
def _linear_polar_gather(h: int, w: int):
    """cv2.linearPolar with centre (0, 0) and radius max(2h, 2w) // 4 over the
    cropped (h, w) spectrum: destination (y, x) samples the source at
    (rho cos phi, rho sin phi), rho = x / w * radius, phi = y / h * 2 pi.
    Host numpy bilinear gather indices (h * w, 4) and weights (h * w, 4)."""
    hh, ww = h, w
    radius = max(hh * 2, ww * 2) // 4
    ys, xs = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    phi = ys * 2 * np.pi / hh
    rho = xs * radius / ww
    sx = rho * np.cos(phi)
    sy = rho * np.sin(phi)
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    valid = (x0 >= 0) & (x0 < ww - 1) & (y0 >= 0) & (y0 < hh - 1)
    x0c, y0c = np.clip(x0, 0, ww - 2), np.clip(y0, 0, hh - 2)
    idx = y0c * ww + x0c
    weights = np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1)
    offsets = np.array([0, 1, ww, ww + 1])
    return (idx[..., None] + offsets).reshape(-1, 4), (weights * valid[..., None]).reshape(-1, 4)


def fft(video: torch.Tensor, norm: str = "forward") -> torch.Tensor:
    _, _, h, w = video.shape
    return torch.fft.rfft2(video, norm=norm)[..., : h // 2, : w // 2]


def video_spectrogram(video: torch.Tensor) -> torch.Tensor:
    """(T, C, H, W) -> (T, W // 2 - 2): the spatial amplitude spectrum,
    clipped to its 0.15 and 99.85 percentiles over the whole clip, warped to
    log-polar and averaged over channels and angles."""
    freqs = fft(video).abs()
    lo, hi = quantiles(freqs, (0.0015, 0.9985))
    freqs = torch.minimum(torch.maximum(freqs, lo), hi)
    T, C, hh, ww = freqs.shape
    idx, wts = _linear_polar_gather(hh, ww)
    idx = torch.as_tensor(idx, device=video.device)
    wts = torch.as_tensor(wts, dtype=torch.float32, device=video.device)
    flat = freqs.reshape(T, C, hh * ww)
    warped = flat[:, :, idx[:, 0]] * wts[:, 0]
    for j in range(1, 4):
        warped = warped + flat[:, :, idx[:, j]] * wts[:, j]
    return warped.reshape(T, C, hh, ww).mean(dim=(1, 2))[:, 2:]


def low_freq_rms(video: torch.Tensor) -> torch.Tensor:
    spec = video_spectrogram(video)
    f = spec.shape[1]
    return (spec[:, : f // 3] ** 2).mean(dim=1, keepdim=True)


def mid_freq_rms(video: torch.Tensor) -> torch.Tensor:
    spec = video_spectrogram(video)
    f = spec.shape[1]
    return (spec[:, f // 3 : 2 * f // 3] ** 2).mean(dim=1, keepdim=True)


def high_freq_rms(video: torch.Tensor) -> torch.Tensor:
    spec = video_spectrogram(video)
    f = spec.shape[1]
    return (spec[:, 2 * f // 3 :] ** 2).mean(dim=1, keepdim=True)


def adaptive_freq_rms(video: torch.Tensor, k: int = 10) -> torch.Tensor:
    """Mean square of the k frequencies that vary most over time (ddof 0; the
    lower frequency first among equal deviations, as ``jax.lax.top_k``)."""
    spec = video_spectrogram(video)
    std = spec.std(dim=0, correction=0)
    top = torch.sort(std, descending=True, stable=True).indices[:k]
    return (spec[:, top] ** 2).mean(dim=1, keepdim=True)


# ----------------------------------------------------------- optical flow --
def optical_flow(video: torch.Tensor, backend: str = "torch") -> torch.Tensor:
    """(T, C, H, W) -> (T, 2, H, W): [standardised magnitude, normalised
    angle] of the flow from each frame to the next (the first pair's flow
    repeated for frame 0).  backend "torch": the port's Farneback on the
    video's device; "cv2": OpenCV's Farneback on the host, the result on the
    video's device."""
    if backend == "cv2":
        return _flow_postprocess(_optical_flow_cv2(video.detach().cpu().numpy()).to(video.device))
    if backend != "torch":
        raise ValueError(f"optical_flow backend is 'torch' or 'cv2', got {backend!r}")
    return _optical_flow_torch(video)


def _flow_postprocess(flow: torch.Tensor) -> torch.Tensor:
    return torch.stack([standardize(flow[:, 0]), normalize(flow[:, 1])], dim=1)


def _optical_flow_torch(video: torch.Tensor) -> torch.Tensor:
    from .flow import farneback_flow

    gray = video.mean(dim=1)
    T, H, W = gray.shape
    step = max(1, FLOW_CHUNK_PIXELS // (H * W))
    uv = torch.cat([farneback_flow(gray[s : min(s + step, T - 1) + 1]) for s in range(0, T - 1, step)])
    flow = torch.cat([uv[:1], uv])
    mag = torch.sqrt(flow[:, 0] ** 2 + flow[:, 1] ** 2)
    ang = torch.atan2(flow[:, 1], flow[:, 0])
    return _flow_postprocess(torch.stack([mag, ang], dim=1))


def _optical_flow_cv2(video: np.ndarray) -> torch.Tensor:
    import cv2

    frames = (np.transpose(video, (0, 2, 3, 1)) * 255).astype(np.uint8)
    grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]
    flows = []
    for prev, nxt in zip(grays[:-1], grays[1:]):
        f = cv2.calcOpticalFlowFarneback(prev, nxt, None, pyr_scale=0.5, levels=6, winsize=25,
                                         iterations=10, poly_n=25, poly_sigma=3.0,
                                         flags=cv2.OPTFLOW_FARNEBACK_GAUSSIAN)
        mag = np.sqrt(f[..., 0] ** 2 + f[..., 1] ** 2)
        ang = np.arctan2(f[..., 1], f[..., 0])
        flows.append(np.stack([mag, ang]))
    return torch.from_numpy(np.stack([flows[0]] + flows))


def directogram(flow: torch.Tensor, bins: int = 8) -> torch.Tensor:
    """(T, 2, H, W) flow features -> (T, bins): the flow magnitudes summed by
    angle bin (each pixel in the first bin whose centre lies within 256 //
    bins of its angle, in levels of 255), then median filtered with 3 taps
    along time and along the bins."""
    from ..generate.latent import linspace

    bin_width = 256 // bins
    angle_bins = linspace(255.0, bins, device=flow.device)
    f255 = torch.floor(flow * 255).to(torch.int32).to(torch.float32)
    mag, ang = f255[:, 0], f255[:, 1]
    bin_idx = torch.zeros(ang.shape, dtype=torch.uint8, device=flow.device)  # no bin matches: bin 0
    for b in range(bins - 1, -1, -1):   # the last write is the first matching bin
        bin_idx = torch.where((angle_bins[b] - ang).abs() <= bin_width, b, bin_idx)
    dg = torch.stack([(mag * (bin_idx == b)).sum(dim=(1, 2)) for b in range(bins)], dim=1)
    dg = dg / dg.new_tensor(255.0)   # a true division on the card too (it takes a host scalar's reciprocal)
    return median_filter(median_filter(dg, 3, axis=0), 3, axis=1)


def video_flow_onsets(video: torch.Tensor, backend: str = "torch") -> torch.Tensor:
    spec = directogram(optical_flow(video, backend=backend))
    return onset_envelope(spectral_flux(spec))[:, None]


def video_spectral_onsets(video: torch.Tensor) -> torch.Tensor:
    spec = video_spectrogram(video)
    return onset_envelope(spectral_flux(spec))[:, None]


VIDEO_FEATURES = {
    "rgb_hist": rgb_hist,
    "hsv_hist": hsv_hist,
    "visual_variance": visual_variance,
    "absdiff": absdiff,
    "video_spectrogram": video_spectrogram,
    "low_freq_rms": low_freq_rms,
    "mid_freq_rms": mid_freq_rms,
    "high_freq_rms": high_freq_rms,
    "adaptive_freq_rms": adaptive_freq_rms,
    "video_flow_onsets": video_flow_onsets,
    "video_spectral_onsets": video_spectral_onsets,
    "directogram": lambda v: directogram(optical_flow(v)),
}
