"""StyleGAN2 generator — functional PyTorch, modulate-input / demodulate-output.

Counterpart of the plain (non-s2d) path of ``ssar_tpu/gan/stylegan2.py``.
Because a conv is linear, the per-sample modulated conv
``conv(x, W * s) * d`` equals ``conv(x * s, W) * d``: one dense batched conv
with the style as an input-channel scale and the demodulation as an
output-channel scale.  Activations run in the synthesis dtype (bf16 on the
card), demodulation accumulates in float32, parameters are float32.

Parameters are a plain dict of tensors in torch layout: conv weights
(out, in, kh, kw), linear weights (out, in), ``const`` (C, 4, 4).
``params_from_jax`` converts the JAX package's pytree ((kh, kw, in, out)
convs, (in, out) linears, (4, 4, C) const), ``params_to_jax`` back.  The
public functions keep the JAX package's layouts for noises (B, H, W, 1) and
images (B, R, R, 3); bends and returned features are NCHW.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.upfirdn import fused_leaky_relu, make_blur_kernel, upfirdn2d, upsample2x


@dataclasses.dataclass(frozen=True)
class StyleGAN2Config:
    resolution: int = 1024
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    blur_kernel: tuple = (1, 3, 3, 1)
    lr_mlp: float = 0.01
    max_channels: int = 512  # width cap; 512 is the reference channel table

    @property
    def log_size(self) -> int:
        return int(np.log2(self.resolution))

    @property
    def n_latent(self) -> int:
        """Number of W+ rows (18 at 1024 px)."""
        return self.log_size * 2 - 2

    @property
    def num_layers(self) -> int:
        """Number of noise inputs (17 at 1024 px)."""
        return (self.log_size - 2) * 2 + 1

    def channels(self) -> dict[int, int]:
        cm = self.channel_multiplier
        full = {4: 512, 8: 512, 16: 512, 32: 512,
                64: 256 * cm, 128: 128 * cm, 256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}
        return {k: min(v, self.max_channels) for k, v in full.items()}

    def noise_shapes(self) -> list[tuple[int, int]]:
        shapes = [(4, 4)]
        for i in range(3, self.log_size + 1):
            shapes += [(2**i, 2**i)] * 2
        return shapes


# ------------------------------------------------------------------ init --
def init_generator(config: StyleGAN2Config, generator: torch.Generator | None = None,
                   device=None) -> dict:
    """Random init with StyleGAN2's distributions (N(0, 1) raw weights and
    run-time equalized-lr scaling), drawn from `generator` on the CPU."""
    chans = config.channels()

    def randn(*shape):
        return torch.randn(shape, generator=generator).to(device)

    def linear(in_f, out_f, bias_init=0.0, lr_mul=1.0):
        return {"weight": randn(out_f, in_f) / lr_mul,
                "bias": torch.full((out_f,), bias_init, device=device)}

    def styled_conv(in_ch, out_ch, k):
        return {"weight": randn(out_ch, in_ch, k, k),
                "mod": linear(config.style_dim, in_ch, bias_init=1.0),
                "noise_weight": torch.zeros((), device=device),
                "bias": torch.zeros(out_ch, device=device)}

    def to_rgb(in_ch):
        return {"weight": randn(3, in_ch, 1, 1),
                "mod": linear(config.style_dim, in_ch, bias_init=1.0),
                "bias": torch.zeros(3, device=device)}

    params = {
        "mapping": [linear(config.style_dim, config.style_dim, lr_mul=config.lr_mlp)
                    for _ in range(config.n_mlp)],
        "const": randn(chans[4], 4, 4),
        "conv1": styled_conv(chans[4], chans[4], 3),
        "to_rgb1": to_rgb(chans[4]),
        "convs": [],
        "to_rgbs": [],
        "w_avg": torch.zeros(config.style_dim, device=device),
    }
    in_ch = chans[4]
    for i in range(3, config.log_size + 1):
        out_ch = chans[2**i]
        params["convs"].append(styled_conv(in_ch, out_ch, 3))   # up-conv
        params["convs"].append(styled_conv(out_ch, out_ch, 3))  # regular conv
        params["to_rgbs"].append(to_rgb(out_ch))
        in_ch = out_ch
    return params


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's generator pytree (numpy or jax arrays) in torch layout."""

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    def lin(p):
        return {"weight": t(np.asarray(p["weight"]).T), "bias": t(p["bias"])}

    def conv(p):
        out = {"weight": t(np.transpose(np.asarray(p["weight"]), (3, 2, 0, 1))),
               "mod": lin(p["mod"]), "bias": t(p["bias"])}
        if "noise_weight" in p:
            out["noise_weight"] = t(p["noise_weight"])
        return out

    return {
        "mapping": [lin(p) for p in tree["mapping"]],
        "const": t(np.transpose(np.asarray(tree["const"]), (2, 0, 1))),
        "conv1": conv(tree["conv1"]),
        "to_rgb1": conv(tree["to_rgb1"]),
        "convs": [conv(p) for p in tree["convs"]],
        "to_rgbs": [conv(p) for p in tree["to_rgbs"]],
        "w_avg": t(tree["w_avg"]),
    }


def params_to_jax(params: dict) -> dict:
    """The port's parameters in the JAX package's layout, as numpy float32
    (the inverse of ``params_from_jax``)."""

    def a(t):
        return t.detach().cpu().float().numpy()

    def lin(p):
        return {"weight": a(p["weight"]).T, "bias": a(p["bias"])}

    def conv(p):
        out = {"weight": a(p["weight"]).transpose(2, 3, 1, 0), "mod": lin(p["mod"]), "bias": a(p["bias"])}
        if "noise_weight" in p:
            out["noise_weight"] = a(p["noise_weight"])
        return out

    return {
        "mapping": [lin(p) for p in params["mapping"]],
        "const": a(params["const"]).transpose(1, 2, 0),
        "conv1": conv(params["conv1"]),
        "to_rgb1": conv(params["to_rgb1"]),
        "convs": [conv(p) for p in params["convs"]],
        "to_rgbs": [conv(p) for p in params["to_rgbs"]],
        "w_avg": a(params["w_avg"]),
    }


# --------------------------------------------------------------- mapping --
def equal_linear(p: dict, x: torch.Tensor, lr_mul: float = 1.0, activation: bool = False) -> torch.Tensor:
    scale = (1.0 / np.sqrt(p["weight"].shape[1])) * lr_mul
    out = x @ (p["weight"] * scale).T
    if activation:
        return fused_leaky_relu(out, p["bias"] * lr_mul)
    return out + p["bias"] * lr_mul


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x**2).mean(dim=-1, keepdim=True) + 1e-8)


def mapping(params: dict, z: torch.Tensor, config: StyleGAN2Config) -> torch.Tensor:
    """z (B, 512) -> w (B, 512)."""
    x = pixel_norm(z)
    for layer in params["mapping"]:
        x = equal_linear(layer, x, lr_mul=config.lr_mlp, activation=True)
    return x


def w_to_wplus(w: torch.Tensor, config: StyleGAN2Config) -> torch.Tensor:
    return w[:, None, :].expand(-1, config.n_latent, -1)


# ------------------------------------------------------------- synthesis --
def prepare_synthesis(params: dict, config: StyleGAN2Config, dtype=torch.float32) -> dict:
    """Every weight-derived constant of the synthesis pass, computed once per
    checkpoint: scaled kernels in the synthesis dtype (the up-convs' already
    in conv_transpose2d's (in, out, kh, kw) layout) and the float32
    demodulation Grams ``w2[o, i] = sum_k (scale * W[o, i, k])**2``."""

    def conv_prep(p, up=False):
        w = p["weight"]
        scaled = w * (1.0 / np.sqrt(w[0].numel()))
        kernel = scaled.transpose(0, 1) if up else scaled
        return {"kernel": kernel.to(dtype).contiguous(), "w2": (scaled.float() ** 2).sum(dim=(2, 3))}

    def rgb_prep(p):
        w = p["weight"]
        return {"kernel": (w * (1.0 / np.sqrt(w[0].numel()))).to(dtype)}

    return {
        "conv1": conv_prep(params["conv1"]),
        "to_rgb1": rgb_prep(params["to_rgb1"]),
        "convs": [conv_prep(p, up=(i % 2 == 0)) for i, p in enumerate(params["convs"])],
        "to_rgbs": [rgb_prep(p) for p in params["to_rgbs"]],
    }


def _modulated_conv(p: dict, prep: dict, x: torch.Tensor, w: torch.Tensor, *, up: bool = False,
                    demodulate: bool = True, blur_kernel=(1, 3, 3, 1), dtype=torch.float32) -> torch.Tensor:
    """x (B, Cin, H, W), w (B, style_dim) -> (B, Cout, H', W')."""
    style = equal_linear(p["mod"], w)  # (B, cin) f32
    # the style is cast down to the compute dtype before the multiply, so a
    # bf16 activation is not promoted to f32
    xs = x.to(dtype) * style.to(dtype)[:, :, None, None]
    kernel = prep["kernel"]
    if up:
        # transposed conv, stride 2 (torch semantics), then the blur
        out = F.conv_transpose2d(xs, kernel, stride=2)
        kh = kernel.shape[-1]
        k = torch.as_tensor(make_blur_kernel(blur_kernel) * 4.0)
        p_ = (len(blur_kernel) - 2) - (kh - 1)
        out = upfirdn2d(out, k, pad=((p_ + 1) // 2 + 1, p_ // 2 + 1))
    else:
        out = F.conv2d(xs, kernel, padding=kernel.shape[-1] // 2)
    if demodulate:
        demod = torch.rsqrt(style.float() ** 2 @ prep["w2"].T + 1e-8)  # (B, cout)
        out = out * demod.to(out.dtype)[:, :, None, None]
    return out


def styled_conv(p: dict, prep: dict, x: torch.Tensor, w: torch.Tensor, noise: torch.Tensor | None, *,
                up: bool = False, blur_kernel=(1, 3, 3, 1), dtype=torch.float32) -> torch.Tensor:
    """noise: (B, 1, H, W) or None."""
    out = _modulated_conv(p, prep, x, w, up=up, blur_kernel=blur_kernel, dtype=dtype)
    if noise is not None:
        out = out + p["noise_weight"].to(out.dtype) * noise.to(out.dtype)
    return fused_leaky_relu(out, p["bias"].to(out.dtype))


def to_rgb(p: dict, prep: dict, x: torch.Tensor, w: torch.Tensor, skip: torch.Tensor | None = None,
           dtype=torch.float32) -> torch.Tensor:
    out = _modulated_conv(p, prep, x, w, demodulate=False, dtype=dtype) + p["bias"].to(dtype)[:, None, None]
    if skip is not None:
        out = out + upsample2x(skip)
    return out


def synthesis(params: dict, latents: torch.Tensor, noises: list | None, config: StyleGAN2Config, *,
              dtype=torch.float32, output_size: int | None = None, prep: dict | None = None,
              return_features: bool = False, bends: dict | None = None, bend_mods: dict | None = None):
    """W+ latents (B, n_latent, 512) [+ noises, a list of (B, H, W, 1) or None]
    -> images (B, R, R, 3) float32 in [-1, 1] (unclamped).

    ``output_size`` below the native resolution stops at the matching skip
    branch (every intermediate skip is a valid image).  ``prep`` comes from
    ``prepare_synthesis`` with the same dtype; it is built here when omitted.

    ``bends`` maps a feature level (0: the 4 x 4 block, after ``conv1``; 1:
    8 x 8, after that level's second conv; ...) to a transform of that level's
    activations, applied before its ``to_rgb`` (the network-bending hook).
    Unlike the JAX package's NHWC, activations are the port's NCHW
    (B, C, H, W).  A transform is called ``transform(x, mod)`` when
    ``bend_mods`` has an entry for its level (this batch's slice of a
    per-frame modulation), else ``transform(x)``.  A bend may change the
    spatial shape; the caller then passes matching noises or None.  With
    ``return_features`` the activations of each level after its bend, NCHW
    in the synthesis dtype, come back too: ``(images, features)``.
    """
    if prep is None:
        prep = prepare_synthesis(params, config, dtype)
    if noises is None:
        noises = [None] * config.num_layers
    noises = [None if n is None else n.permute(0, 3, 1, 2) for n in noises]  # NHWC -> NCHW views
    bends, bend_mods = bends or {}, bend_mods or {}
    B = latents.shape[0]

    def bend(level, x):
        if level not in bends:
            return x
        return bends[level](x, bend_mods[level]) if level in bend_mods else bends[level](x)

    const = params["const"].to(dtype)
    x = const[None].expand(B, *const.shape)
    x = bend(0, styled_conv(params["conv1"], prep["conv1"], x, latents[:, 0], noises[0], dtype=dtype))
    feats = [x] if return_features else None   # kept only when asked: each level's activations stay alive
    skip = to_rgb(params["to_rgb1"], prep["to_rgb1"], x, latents[:, 1], dtype=dtype)

    if output_size is None or output_size > 4:
        i = 1
        for level, (conv_up, conv) in enumerate(zip(params["convs"][::2], params["convs"][1::2])):
            res = 2 ** (level + 3)
            x = styled_conv(conv_up, prep["convs"][2 * level], x, latents[:, i], noises[i], up=True,
                            blur_kernel=config.blur_kernel, dtype=dtype)
            x = styled_conv(conv, prep["convs"][2 * level + 1], x, latents[:, i + 1], noises[i + 1],
                            dtype=dtype)
            x = bend(level + 1, x)
            if return_features:
                feats.append(x)
            skip = to_rgb(params["to_rgbs"][level], prep["to_rgbs"][level], x, latents[:, i + 2], skip,
                          dtype=dtype)
            i += 2
            if output_size is not None and res >= output_size:
                break
    img = skip.float().permute(0, 2, 3, 1)
    return (img, feats) if return_features else img


def generate(params: dict, z: torch.Tensor, config: StyleGAN2Config, *, truncation: float = 1.0,
             noises: list | None = None, dtype=torch.float32) -> torch.Tensor:
    """z (B, 512) -> images: mapping, truncation towards ``w_avg``, broadcast
    to W+ and synthesis."""
    w = mapping(params, z, config)
    if truncation < 1.0:
        w = params["w_avg"] + truncation * (w - params["w_avg"])
    return synthesis(params, w_to_wplus(w, config), noises, config, dtype=dtype)
