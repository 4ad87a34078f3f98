"""AV embedding extractors: VGGish (audio), a lightweight SlowFast-style video
net, and the synchro-saliency curve built on both.

Counterpart of ``ssar_tpu/models/extractors.py``.  ``VGGish`` is channels-
first with torchvggish's module names (``features.{0,3,6,8,11,13}`` convs,
``embeddings.{0,2,4}`` linears) and flattens (C, H, W) as torch does, so a
torchvggish ``state_dict`` loads as it is; as in the JAX model its last
linear has no ReLU.  ``SlowFastVideo`` has the torch names the JAX package's
converter reads (``{slow,fast}_stem``, ``{slow,fast}_b{0,1,2}``, ``head``)
and pads as flax's ``padding="SAME"`` does (the extra pixel at the end of a
strided axis).  Without weights the extractors draw their own from a
``torch.Generator`` seeded by `seed` (``random_vggish``,
``random_slowfast_video``): usable for relative (synchrony) comparisons.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.spectral import frame_signal, hann_window, mel_basis
from ..ops.resample import resample
from ..utils.device import full_precision, resolve_device
from ._flax import same_pad


def vggish_log_mel(audio: torch.Tensor, sr: int = 16000) -> torch.Tensor:
    """AudioSet VGGish front end: 64-band log-mel patches of 96 frames (25 ms
    windows, 10 ms hop, mel 125-7500 Hz) -> (n_examples, 96, 64)."""
    win = int(round(sr * 0.025))
    hop = int(round(sr * 0.010))
    n_fft = int(2 ** np.ceil(np.log2(win)))
    frames = frame_signal(audio, win, hop, center=False) * torch.as_tensor(hann_window(win), device=audio.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=1).abs()
    basis = torch.as_tensor(mel_basis(sr, n_fft, n_mels=64, fmin=125.0, fmax=7500.0), device=audio.device)
    with full_precision():
        mel = torch.log(spec @ basis.T + 0.01)
    n_ex = mel.shape[0] // 96
    return mel[: n_ex * 96].reshape(n_ex, 96, 64)


class VGGish(nn.Module):
    """(N, 96, 64) log-mel patches -> (N, 128) embeddings."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 1
        for widths in ((64,), (128,), (256, 256), (512, 512)):
            for w in widths:
                layers += [nn.Conv2d(cin, w, 3, padding=1), nn.ReLU()]
                cin = w
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.embeddings = nn.Sequential(nn.Linear(512 * 6 * 4, 4096), nn.ReLU(), nn.Linear(4096, 4096), nn.ReLU(),
                                        nn.Linear(4096, 128))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embeddings(self.features(x[:, None]).flatten(1))


class SlowFastVideo(nn.Module):
    """Two-pathway 3-D conv video net: a slow pathway over every alpha-th frame
    and a fast low-channel one over all frames, the fast stream averaged down
    to the slow frame rate and concatenated.  (B, 3, T, H, W) -> (B, 256).
    For the faithful SLOWFAST_8x8_R50 see ``models.slowfast_r50``."""

    def __init__(self, features: int = 32, alpha: int = 4):
        super().__init__()
        self.alpha = alpha
        for name, width in (("slow", features), ("fast", features // 4)):
            setattr(self, f"{name}_stem", nn.Conv3d(3, width, (1, 7, 7), (1, 2, 2)))
            for i in range(3):
                setattr(self, f"{name}_b{i}", nn.Conv3d(width * 2**i, width * 2 ** (i + 1), 3, (1, 2, 2)))
        self.head = nn.Linear(features * 8 + features // 4 * 8, 256)

    def _pathway(self, x: torch.Tensor, name: str) -> torch.Tensor:
        for layer in ("stem", "b0", "b1", "b2"):
            conv = getattr(self, f"{name}_{layer}")
            x = F.relu(conv(same_pad(x, conv.kernel_size, conv.stride)))
        return x

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        hs = self._pathway(video[:, :, :: self.alpha], "slow")
        hf = self._pathway(video, "fast")
        hf = F.avg_pool3d(hf, (self.alpha, 1, 1))[:, :, : hs.shape[2]]
        return self.head(torch.cat([hs, hf], dim=1).mean(dim=(2, 3, 4)))


def _randomised(module: nn.Module, seed: int) -> nn.Module:
    """`module` with every weight drawn as lecun normal (flax's default
    kernel init: variance 1 / fan_in) and zero biases, from a CPU
    ``torch.Generator`` seeded by `seed`."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=g) / float(np.prod(p.shape[1:])) ** 0.5)
    return module


def random_vggish(seed: int = 0) -> VGGish:
    return _randomised(VGGish(), seed)


def random_slowfast_video(seed: int = 0) -> SlowFastVideo:
    return _randomised(SlowFastVideo(), seed)


class VggishExtractor:
    """Audio -> a sequence of 128-d embeddings (one per 0.96 s), on the card
    unless ``device="cpu"``."""

    def __init__(self, model: VGGish | None = None, seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = (model if model is not None else random_vggish(seed)).to(self.device).eval()

    @torch.no_grad()
    def __call__(self, audio, sr: int) -> torch.Tensor:
        audio = torch.as_tensor(audio if torch.is_tensor(audio) else np.asarray(audio),
                                dtype=torch.float32).to(self.device)
        if sr != 16000:
            audio = resample(audio, int(sr), 16000, lowpass_filter_width=6)
        with full_precision():
            return self.model(vggish_log_mel(audio))


class SlowFastExtractor:
    """Video (T, 3, H, W) or (T, H, W, 3) in [0, 1] -> (T // clip_len, 256)
    clip embeddings, on the card unless ``device="cpu"``."""

    def __init__(self, model: SlowFastVideo | None = None, seed: int = 0, clip_len: int = 16,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = (model if model is not None else random_slowfast_video(seed)).to(self.device).eval()
        self.clip_len = clip_len

    @torch.no_grad()
    def __call__(self, video) -> torch.Tensor:
        video = torch.as_tensor(video if torch.is_tensor(video) else np.asarray(video),
                                dtype=torch.float32).to(self.device)
        if video.shape[1] != 3:
            video = video.permute(0, 3, 1, 2)   # (T, H, W, 3) -> (T, 3, H, W)
        n = video.shape[0] // self.clip_len
        clips = video[: n * self.clip_len].reshape(n, self.clip_len, *video.shape[1:]).transpose(1, 2)
        with full_precision():
            return self.model(clips)


def synchro_saliency(audio, sr: int, video, fps: int, seed: int = 0,
                     device: str | torch.device | None = None) -> torch.Tensor:
    """AV synchrony curve: the cosine similarity of time-aligned VGGish audio
    and SlowFast video embeddings (the first min(n_audio, n_video) of each,
    on their first min(128, 256) dimensions), on the card unless
    ``device="cpu"``."""
    a = VggishExtractor(seed=seed, device=device)(audio, sr)   # one embedding / 0.96 s
    v = SlowFastExtractor(seed=seed, device=device)(video)     # one embedding / clip_len frames
    n = min(a.shape[0], v.shape[0])
    d = min(a.shape[1], v.shape[1])
    a, v = a[:n, :d], v[:n, :d]
    a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-8)
    v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-8)
    return (a * v).sum(dim=1)
