"""Plain StyleGAN2 (config-f layout) in float32: mapping, synthesis and the
I420 packing of the frames.

Written from the published architecture (Karras et al. 2020, rosinality's
layout) and not from the port: each modulated convolution scales its kernel
per sample by the style and demodulates the kernel (a grouped convolution
with one group a frame), where the port scales the input and the output.
``quant`` rounds each convolution's two operands (the control's fp8); None
keeps float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLUR = (1.0, 3.0, 3.0, 1.0)


def channels(resolution: int, channel_multiplier: int = 2, max_channels: int = 512) -> dict[int, int]:
    cm = channel_multiplier
    full = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm, 256: 64 * cm, 512: 32 * cm,
            1024: 16 * cm}
    return {r: min(c, max_channels) for r, c in full.items() if r <= resolution}


def init_like_port(resolution: int, seed: int, style_dim: int = 512, n_mlp: int = 8, lr_mlp: float = 0.01,
                   channel_multiplier: int = 2, max_channels: int = 512) -> dict:
    """StyleGAN2's random initialisation in the order the random-patch entry
    draws it: N(0, 1) raw weights from a CPU generator seeded with `seed`,
    mapping weights divided by their learning-rate multiplier, style biases 1,
    every other bias, the noise strengths and w_avg 0."""
    g = torch.Generator().manual_seed(int(seed))
    chans = channels(resolution, channel_multiplier, max_channels)

    def linear(i, o, bias=0.0, lr_mul=1.0):
        return {"weight": torch.randn((o, i), generator=g) / lr_mul, "bias": torch.full((o,), bias)}

    def conv(i, o, k):
        return {"weight": torch.randn((o, i, k, k), generator=g), "mod": linear(style_dim, i, 1.0),
                "noise_weight": torch.zeros(()), "bias": torch.zeros(o)}

    def rgb(i):
        return {"weight": torch.randn((3, i, 1, 1), generator=g), "mod": linear(style_dim, i, 1.0),
                "bias": torch.zeros(3)}

    p = {"mapping": [linear(style_dim, style_dim, lr_mul=lr_mlp) for _ in range(n_mlp)],
         "const": torch.randn((chans[4], 4, 4), generator=g)}
    p["conv1"] = conv(chans[4], chans[4], 3)
    p["to_rgb1"] = rgb(chans[4])
    p["convs"], p["to_rgbs"] = [], []
    c = chans[4]
    for r in sorted(chans)[1:]:
        p["convs"] += [conv(c, chans[r], 3), conv(chans[r], chans[r], 3)]
        p["to_rgbs"].append(rgb(chans[r]))
        c = chans[r]
    return p


def to_device(p, device):
    if isinstance(p, torch.Tensor):
        return p.to(device, torch.float32)
    if isinstance(p, dict):
        return {k: to_device(v, device) for k, v in p.items()}
    return [to_device(v, device) for v in p]


def _leaky(x, bias):
    return F.leaky_relu(x + bias.reshape(1, -1, 1, 1), 0.2) * math.sqrt(2.0)


def mapping(p: dict, z: torch.Tensor, lr_mlp: float = 0.01) -> torch.Tensor:
    """z (B, 512) -> w (B, 512): pixel norm, then equalized-lr linears with leaky ReLU."""
    x = z * torch.rsqrt((z * z).mean(dim=-1, keepdim=True) + 1e-8)
    for layer in p["mapping"]:
        w = layer["weight"]
        x = x @ (w * ((1.0 / math.sqrt(w.shape[1])) * lr_mlp)).T
        x = F.leaky_relu(x + layer["bias"] * lr_mlp, 0.2) * math.sqrt(2.0)
    return x


def _blur_kernel(gain: float, device) -> torch.Tensor:
    k = torch.tensor(BLUR, dtype=torch.float64)
    k = torch.outer(k, k)
    return (k / k.sum() * gain).to(device, torch.float32)


def _upfirdn(x: torch.Tensor, kernel: torch.Tensor, up: int, pad: tuple[int, int]) -> torch.Tensor:
    """Zero-insertion upsampling, padding, then a true 2-D convolution per channel."""
    B, C, H, W = x.shape
    if up > 1:
        z = x.new_zeros(B, C, H, up, W, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(B, C, H * up, W * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.flip(kernel, (0, 1))
    return F.conv2d(x, k.expand(C, 1, *k.shape), groups=C)


def _modulated(layer: dict, x: torch.Tensor, w: torch.Tensor, *, demodulate: bool, up: bool, quant) -> torch.Tensor:
    B, cin, H, W = x.shape
    mod = layer["mod"]
    style = w @ (mod["weight"] * (1.0 / math.sqrt(mod["weight"].shape[1]))).T + mod["bias"]   # (B, cin)
    weight = layer["weight"]
    cout, _, k, _ = weight.shape
    kern = weight[None] * (1.0 / math.sqrt(cin * k * k)) * style[:, None, :, None, None]   # (B, cout, cin, k, k)
    if demodulate:
        kern = kern * torch.rsqrt((kern * kern).sum(dim=(2, 3, 4)) + 1e-8)[:, :, None, None, None]
    if quant is not None:
        x, kern = quant(x), quant(kern)
    x = x.reshape(1, B * cin, H, W)
    if up:
        kern = kern.transpose(1, 2).reshape(B * cin, cout, k, k)
        out = F.conv_transpose2d(x, kern, stride=2, groups=B)
        out = out.reshape(B, cout, *out.shape[2:])
        return _upfirdn(out, _blur_kernel(4.0, x.device), 1, (1, 1))
    out = F.conv2d(x, kern.reshape(B * cout, cin, k, k), padding=k // 2, groups=B)
    return out.reshape(B, cout, *out.shape[2:])


def _styled(layer, x, w, noise, *, up=False, quant=None):
    out = _modulated(layer, x, w, demodulate=True, up=up, quant=quant)
    if noise is not None:
        out = out + layer["noise_weight"] * noise
    return _leaky(out, layer["bias"])


def _rgb(layer, x, w, skip, quant=None):
    out = _modulated(layer, x, w, demodulate=False, up=False, quant=quant) + layer["bias"].reshape(1, -1, 1, 1)
    if skip is not None:
        out = out + _upfirdn(skip, _blur_kernel(4.0, skip.device), 2, (2, 1))
    return out


def synthesis(p: dict, latents: torch.Tensor, noises: list, quant=None, size: int | None = None) -> torch.Tensor:
    """W+ latents (B, n_ws, 512) and per-layer noise (B, 1, H, W) or None
    (4 px first, two a resolution after it) -> images (B, 3, R, R) in about
    [-1, 1], unclamped; with `size`, the skip branch's image at that
    resolution (the layers above it not run)."""
    B = latents.shape[0]
    x = p["const"][None].expand(B, *p["const"].shape)
    x = _styled(p["conv1"], x, latents[:, 0], noises[0], quant=quant)
    skip = _rgb(p["to_rgb1"], x, latents[:, 1], None, quant)
    for level, rgb in enumerate(p["to_rgbs"]):
        i = 1 + 2 * level
        x = _styled(p["convs"][2 * level], x, latents[:, i], noises[i], up=True, quant=quant)
        x = _styled(p["convs"][2 * level + 1], x, latents[:, i + 1], noises[i + 1], quant=quant)
        skip = _rgb(rgb, x, latents[:, i + 2], skip, quant)
        if size is not None and skip.shape[-1] >= size:
            break
    return skip


def to_i420(images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) images in [-1, 1] -> (B, H * 3 // 2, W) uint8 I420:
    studio-range BT.601, chroma as 2 x 2 means, each plane rounded half up."""
    x = torch.clamp((images.float() + 1.0) / 2.0, 0.0, 1.0) * 255.0
    B, _, H, W = x.shape
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    r2, g2, b2 = (F.avg_pool2d(c[:, None], 2)[:, 0] for c in (r, g, b))
    u = 128.0 - 0.148223 * r2 - 0.290993 * g2 + 0.439216 * b2
    v = 128.0 + 0.439216 * r2 - 0.367788 * g2 - 0.071427 * b2
    q = lambda t: (t + 0.5).to(torch.uint8)   # noqa: E731
    return torch.cat([q(y), q(u).reshape(B, H // 4, W), q(v).reshape(B, H // 4, W)], dim=1)
