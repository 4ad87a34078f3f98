"""LatentNoiseReactor — features -> StyleGAN2 W+ latents + noise pyramid.

Counterpart of ``ssar_tpu/models/reactor.py``: an EnvelopeReactor
(normalise -> Linear + GELU -> backbone -> GELU + Linear) produces per-frame
envelopes that a decoder turns into W+ sequences (B, T, n_ws, 512) plus a
4-level noise pyramid [(B, T, 4, 4) ... (B, T, 32, 32)]:
- ``FixedLatentNoiseDecoder``: convex-ish mixes of a frozen W+ palette;
- ``LearnedLatentNoiseDecoder``: layerwise MLP heads and a (mu, sigma) noise
  head (``noise_mode="musigma"``) or the v1 reactor's 3-D-conv pyramid
  (``noise_mode="conv3d"``, ``ConvNoiseUpsampler``).

The base noise is time-smoothed standard noise.  JAX's random stream cannot
be reproduced in torch, so it comes from a ``torch.Generator`` or is injected
by the caller (``base_noise``) — the parity tests inject the same arrays into
both packages.  Dropout masks come from ``dropout_generator`` when training.
Module names follow the flax modules (``load_flax``, ``flax_tree``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..generate import keys
from ..ops.gaussian import gaussian_filter
from ..ops.resize import resize
from ._flax import Conv, FlaxModule, dropout, gelu
from .backbones import make_backbone


def _buffer(a) -> torch.Tensor:
    """A float32 copy of a tensor (kept on its device) or of an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).clone(memory_format=torch.contiguous_format)
    return torch.tensor(np.asarray(a), dtype=torch.float32)


class Normalize(nn.Module):
    """Fixed input standardisation."""

    def __init__(self, mean, std):
        super().__init__()
        self.register_buffer("mean", _buffer(mean))
        self.register_buffer("std", _buffer(std))

    def forward(self, x):
        return (x - self.mean) / (self.std + 1e-8)


class EnvelopeReactor(FlaxModule):
    """(B, T, F) features -> (B, T, E) envelopes."""

    def __init__(self, input_mean, input_std, hidden_size: int = 64, output_size: int | None = None,
                 num_layers: int = 4, backbone: str = "gru", dropout: float = 0.0):
        super().__init__()
        self.normalize = Normalize(input_mean, input_std)
        self.inp = nn.Linear(self.normalize.mean.shape[-1], hidden_size)
        self.backbone, self._backbone_name = make_backbone(backbone, hidden_size, num_layers, dropout)
        self.out = nn.Linear(hidden_size, hidden_size if output_size is None else output_size)

    def flax_children(self):
        return {"Dense_0": self.inp, self._backbone_name: self.backbone, "Dense_1": self.out}

    def forward(self, x, generator: torch.Generator | None = None):
        h = gelu(self.inp(self.normalize(x)))
        return self.out(gelu(self.backbone(h, generator)))


def smoothed_noise(shape_bt: tuple[int, int], size: int, sigma: float = 5.0, *,
                   generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Time-smoothed standard noise (B, T, size, size): randn smoothed along T."""
    B, T = shape_bt
    n = keys.global_draw(lambda s: torch.randn(s, generator=generator, device=device), (T, B, size, size), axis=1)
    return gaussian_filter(n, sigma).permute(1, 0, 2, 3)


def _base(base_noise, i: int, x: torch.Tensor, size: int, generator) -> torch.Tensor:
    if base_noise is not None:
        return torch.as_tensor(base_noise[i], dtype=x.dtype, device=x.device)
    return smoothed_noise((x.shape[0], x.shape[1]), size, generator=generator, device=x.device)


class FixedLatentNoiseDecoder(nn.Module):
    """Envelopes -> convex-ish mixes of a frozen W+ palette, plus noise maps.

    latents: (S*H, n_ws, 512) palette; envelopes (B, T, S*H + 2*n_noise).
    Each of the S splits mixes its H palette rows over its n_ws/S W+ rows
    (S must divide n_ws: 3 for StyleGAN2's 18 rows, 4 for StyleGAN3's 16);
    the trailing 2*n_noise envelopes are (mu, sigma) pairs scaling smoothed
    noise at 4x4 .. 32x32.  ``env_guard_eps`` > 0 clamps |sum| of each
    split's envelopes away from zero, keeping its sign (0 = the reference's
    unguarded normalisation).
    """

    def __init__(self, latents, hidden_size: int = 12, n_latent_split: int = 3, n_noise: int = 4,
                 env_guard_eps: float = 0.0):
        super().__init__()
        self.register_buffer("latents", _buffer(latents))
        self.hidden_size, self.n_latent_split, self.n_noise = hidden_size, n_latent_split, n_noise
        self.env_guard_eps = env_guard_eps
        if self.latents.shape[0] != n_latent_split * hidden_size:
            raise ValueError(f"palette has {self.latents.shape[0]} rows, expected {n_latent_split * hidden_size}")
        if self.latents.shape[1] % n_latent_split:
            raise ValueError(f"{self.latents.shape[1]} W+ rows do not split into {n_latent_split} equal parts")

    def forward(self, x, base_noise: list | None = None, generator: torch.Generator | None = None):
        S, H = self.n_latent_split, self.hidden_size
        W = self.latents.shape[1] // S
        outs = []
        for i in range(S):
            env = x[..., i * H : (i + 1) * H]
            s = env.sum(dim=-1, keepdim=True)
            if self.env_guard_eps:
                eps = self.env_guard_eps
                s = torch.where(s.abs() < eps, torch.where(s >= 0, eps, -eps).to(s.dtype), s)
            lat = self.latents[i * H : (i + 1) * H, i * W : (i + 1) * W]
            outs.append(torch.einsum("bth,hwl->btwl", env / s, lat))
        latents = torch.cat(outs, dim=2)

        noise_envs = x[..., S * H :]
        noise = []
        for i in range(noise_envs.shape[-1] // 2):
            mu = noise_envs[..., 2 * i][..., None, None]
            sig = noise_envs[..., 2 * i + 1][..., None, None]
            noise.append(mu + sig * _base(base_noise, i, x, 2 ** (i + 2), generator))
        return latents, noise


class NoiseHead(FlaxModule):
    """Learned per-scale (mu, sigma) noise head: each scale's two envelopes
    come from a Dense(C // 2) -> GELU -> dropout -> Dense(2) head."""

    def __init__(self, in_features: int, n_outputs: int = 4, dropout: float = 0.0):
        super().__init__()
        self.heads = nn.ModuleList(
            nn.Sequential(nn.Linear(in_features, in_features // 2), nn.Linear(in_features // 2, 2))
            for _ in range(n_outputs))
        self.dropout = dropout

    def flax_children(self):
        return {f"Dense_{2 * i + j}": head[j] for i, head in enumerate(self.heads) for j in range(2)}

    def forward(self, x, base_noise=None, generator=None, dropout_generator=None):
        noise = []
        for i, (hidden, mu_sig) in enumerate(self.heads):
            h = dropout(gelu(hidden(x)), self.dropout, self.training, dropout_generator)
            ms = mu_sig(h)
            mu, sig = ms[..., 0][..., None, None], ms[..., 1][..., None, None]
            noise.append(mu + sig * _base(base_noise, i, x, 2 ** (i + 2), generator))
        return noise


class ConvNoiseUpsampler(FlaxModule):
    """The v1 reactor's content-generated noise pyramid: a GLU (h * gelu(gate))
    expands each frame's hidden state into a 2 x 2 seed of `features`
    channels, a 3 x 3 x 3 conv (time as depth), then per scale a bilinear
    half-pixel resize of the two spatial axes, a conv + GELU and a 1-channel
    conv tap -> noise maps (B, T, 4, 4) .. (B, T, 32, 32).  NCDHW, padding 1:
    flax's NDHWC ``SAME``.  Deterministic (no draws)."""

    def __init__(self, in_features: int, features: int, n_outputs: int = 4):
        super().__init__()
        D = self.features = features
        self.glu = nn.Linear(in_features, D * 8)
        self.convs = nn.ModuleList([Conv(D, D, (3, 3, 3))])
        for _ in range(n_outputs):
            self.convs.extend([Conv(D, D, (3, 3, 3)), Conv(D, 1, (3, 3, 3))])
        self.n_outputs = n_outputs

    def flax_children(self):
        return {"Dense_0": self.glu, **{f"Conv_{i}": c for i, c in enumerate(self.convs)}}

    def forward(self, x: torch.Tensor) -> list:
        B, T, _ = x.shape
        D = self.features
        h, gate = self.glu(x).chunk(2, dim=-1)
        h = (h * gelu(gate)).reshape(B, T, 2, 2, D).permute(0, 4, 1, 2, 3)   # (B, D, T, 2, 2)
        h = gelu(self.convs[0].forward_cf(h))
        noise = []
        for i in range(self.n_outputs):
            # the spatial resize as two small products with its weights (``resize`` of the identity):
            # F.interpolate's bilinear kernel loops over batch x channels x frames in each thread (a
            # gradient step at batch 32 x 192 frames took 6.5 s with it on an H100)
            w = resize(torch.eye(h.shape[-1], device=h.device), (h.shape[-1], 2 ** (i + 2)), "linear",
                       antialias=False)
            h = (h.transpose(-1, -2) @ w).transpose(-1, -2) @ w
            h = gelu(self.convs[2 * i + 1].forward_cf(h))
            noise.append(self.convs[2 * i + 2].forward_cf(h)[:, 0])
        return noise


class LayerwiseLinear(FlaxModule):
    """n_outputs W+ rows produced by n_layerwise independent two-layer MLPs."""

    def __init__(self, in_features: int, out_channels: int = 512, n_outputs: int = 18, n_layerwise: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        if n_outputs % n_layerwise:
            raise ValueError(f"n_outputs {n_outputs} is not a multiple of n_layerwise {n_layerwise}")
        self.per, self.out_channels = n_outputs // n_layerwise, out_channels
        self.heads = nn.ModuleList(
            nn.Sequential(nn.Linear(in_features, out_channels), nn.Linear(out_channels, self.per * out_channels))
            for _ in range(n_layerwise))
        self.dropout = dropout

    def flax_children(self):
        return {f"Dense_{2 * i + j}": head[j] for i, head in enumerate(self.heads) for j in range(2)}

    def forward(self, x, dropout_generator=None):
        outs = []
        for first, second in self.heads:
            h = dropout(gelu(first(x)), self.dropout, self.training, dropout_generator)
            outs.append(second(h).reshape(x.shape[0], x.shape[1], self.per, self.out_channels))
        return torch.cat(outs, dim=2)  # (B, T, n_outputs, 512)


class LearnedLatentNoiseDecoder(FlaxModule):
    """Envelopes -> GELU -> dropout -> (LayerwiseLinear latents, noise from the
    NoiseHead (``noise_mode="musigma"``) or the ConvNoiseUpsampler ("conv3d"))."""

    def __init__(self, in_features: int, n_ws: int = 18, n_latent_split: int = 3, n_noise: int = 4,
                 dropout: float = 0.0, noise_mode: str = "musigma"):
        super().__init__()
        if noise_mode not in ("musigma", "conv3d"):
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        self.layerwise = LayerwiseLinear(in_features, 512, n_ws, n_latent_split, dropout)
        if noise_mode == "conv3d":
            self.noise_head = ConvNoiseUpsampler(in_features, in_features, n_noise)
        else:
            self.noise_head = NoiseHead(in_features, n_noise, dropout)
        self.noise_mode, self.dropout = noise_mode, dropout

    def flax_children(self):
        head = "ConvNoiseUpsampler_0" if self.noise_mode == "conv3d" else "NoiseHead_0"
        return {"LayerwiseLinear_0": self.layerwise, head: self.noise_head}

    def forward(self, x, base_noise=None, generator=None, dropout_generator=None):
        h = dropout(gelu(x), self.dropout, self.training, dropout_generator)
        latents = self.layerwise(h, dropout_generator)
        if self.noise_mode == "conv3d":
            return latents, self.noise_head(h)
        return latents, self.noise_head(h, base_noise, generator, dropout_generator)


class LatentNoiseReactor(FlaxModule):
    """features (B, T, F) -> (latents (B, T, n_ws, 512), [4 noise maps]).

    Backbones "sashimi" (the default, as in the JAX package), "gru", "lstm",
    "conv", "mlp" and "transformer"; decoders "fixed" (needs the W+ palette
    ``latents``) and "learned" (``noise_mode`` "musigma" or "conv3d").  Build
    it on the CPU and move it with ``.to(device)``; ``load_flax`` copies the
    JAX package's variables in.
    """

    def __init__(self, input_mean, input_std, latents=None, env_guard_eps: float = 0.0,
                 residual: bool = True, num_layers: int = 2, backbone: str = "sashimi",
                 hidden_size: int = 64, decoder: str = "fixed", n_latent_split: int = 3,
                 n_noise: int = 4, dropout: float = 0.0, n_ws: int = 18, noise_mode: str = "musigma"):
        super().__init__()
        if decoder not in ("fixed", "learned"):
            raise ValueError(f"unknown decoder {decoder!r}")
        self.residual = residual
        n_envelopes = hidden_size * n_latent_split + 2 * n_noise if decoder == "fixed" else hidden_size
        self.envelopes = EnvelopeReactor(input_mean, input_std, hidden_size=n_envelopes,
                                         num_layers=num_layers, backbone=backbone, dropout=dropout)
        if decoder == "fixed":
            if latents is None:
                raise ValueError("the fixed decoder needs a W+ palette (latents)")
            self.decoder = FixedLatentNoiseDecoder(latents, hidden_size, n_latent_split, n_noise,
                                                   env_guard_eps=env_guard_eps)
        else:
            self.decoder = LearnedLatentNoiseDecoder(n_envelopes, n_ws, n_latent_split, n_noise, dropout,
                                                     noise_mode=noise_mode)

    def flax_children(self):
        children = {"EnvelopeReactor_0": self.envelopes}
        if isinstance(self.decoder, LearnedLatentNoiseDecoder):
            children["LearnedLatentNoiseDecoder_0"] = self.decoder
        return children

    def forward(self, x, base_noise: list | None = None, generator: torch.Generator | None = None,
                dropout_generator: torch.Generator | None = None, return_envelopes: bool = False):
        envelopes = self.envelopes(x, dropout_generator)
        if return_envelopes:
            return envelopes
        if isinstance(self.decoder, FixedLatentNoiseDecoder):
            latents, noise = self.decoder(envelopes, base_noise=base_noise, generator=generator)
        else:
            latents, noise = self.decoder(envelopes, base_noise=base_noise, generator=generator,
                                          dropout_generator=dropout_generator)
        if self.residual:
            latents = latents - latents.mean(dim=1, keepdim=True)
        return latents, noise

    def load_flax(self, variables: dict) -> "LatentNoiseReactor":
        """Copy a flax ``LatentNoiseReactor``'s variables ({"params": ...}) in."""
        return super().load_flax(variables.get("params", variables))
