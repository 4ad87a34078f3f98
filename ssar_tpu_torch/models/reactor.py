"""LatentNoiseReactor with the fixed palette decoder.

Counterpart of ``ssar_tpu/models/reactor.py``: an EnvelopeReactor
(normalise -> Linear + GELU -> backbone -> GELU + Linear) produces per-frame
envelopes that the FixedLatentNoiseDecoder turns into StyleGAN2 W+ sequences
(B, T, n_ws, 512) plus a 4-level noise pyramid [(B, T, 4, 4) ... (B, T, 32, 32)].

The decoder's base noise is time-smoothed standard noise.  JAX's random
stream cannot be reproduced in torch, so the noise comes from a
``torch.Generator`` or is injected by the caller (``base_noise``) — the
parity tests inject the same arrays into both packages.  flax ``nn.gelu``
defaults to the tanh approximation, and so does this port.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gaussian import gaussian_filter
from .backbones import MultiLayerRNN


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _buffer(a) -> torch.Tensor:
    """A float32 copy of a tensor (kept on its device) or of an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).clone()
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _dense_from_flax(linear: nn.Linear, p: dict) -> None:
    with torch.no_grad():
        linear.weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
        linear.bias.copy_(torch.tensor(np.asarray(p["bias"])))


class Normalize(nn.Module):
    """Fixed input standardisation."""

    def __init__(self, mean, std):
        super().__init__()
        self.register_buffer("mean", _buffer(mean))
        self.register_buffer("std", _buffer(std))

    def forward(self, x):
        return (x - self.mean) / (self.std + 1e-8)


class EnvelopeReactor(nn.Module):
    """(B, T, F) features -> (B, T, E) envelopes."""

    def __init__(self, input_mean, input_std, hidden_size: int = 64, output_size: int | None = None,
                 num_layers: int = 4, backbone: str = "gru", dropout: float = 0.0):
        super().__init__()
        self.normalize = Normalize(input_mean, input_std)
        self.inp = nn.Linear(self.normalize.mean.shape[-1], hidden_size)
        self.backbone = MultiLayerRNN(hidden_size, num_layers, backbone.lower(), dropout)
        self.out = nn.Linear(hidden_size, hidden_size if output_size is None else output_size)

    def forward(self, x):
        h = _gelu(self.inp(self.normalize(x)))
        return self.out(_gelu(self.backbone(h)))

    def load_flax(self, params: dict) -> None:
        _dense_from_flax(self.inp, params["Dense_0"])
        self.backbone.load_flax(params["MultiLayerRNN_0"])
        _dense_from_flax(self.out, params["Dense_1"])


def smoothed_noise(shape_bt: tuple[int, int], size: int, sigma: float = 5.0, *,
                   generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Time-smoothed standard noise (B, T, size, size): randn smoothed along T."""
    B, T = shape_bt
    n = torch.randn((T, B, size, size), generator=generator, device=device)
    return gaussian_filter(n, sigma).permute(1, 0, 2, 3)


class FixedLatentNoiseDecoder(nn.Module):
    """Envelopes -> convex-ish mixes of a frozen W+ palette, plus noise maps.

    latents: (S*H, n_ws, 512) palette; envelopes (B, T, S*H + 2*n_noise).
    Each of the S splits mixes its H palette rows over its n_ws/S W+ rows;
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
        B, T = x.shape[0], x.shape[1]
        noise = []
        for i in range(noise_envs.shape[-1] // 2):
            mu = noise_envs[..., 2 * i][..., None, None]
            sig = noise_envs[..., 2 * i + 1][..., None, None]
            if base_noise is not None:
                base = torch.as_tensor(base_noise[i], dtype=x.dtype, device=x.device)
            else:
                base = smoothed_noise((B, T), 2 ** (i + 2), generator=generator, device=x.device)
            noise.append(mu + sig * base)
        return latents, noise


class LatentNoiseReactor(nn.Module):
    """features (B, T, F) -> (latents (B, T, n_ws, 512), [4 noise maps]).

    Only ``decoder="fixed"`` with the GRU backbone is ported.  Build it on the
    CPU and move it with ``.to(device)``; ``load_flax`` copies the JAX
    package's parameters in.
    """

    def __init__(self, input_mean, input_std, latents=None, env_guard_eps: float = 0.0,
                 residual: bool = True, num_layers: int = 2, backbone: str = "gru",
                 hidden_size: int = 64, decoder: str = "fixed", n_latent_split: int = 3,
                 n_noise: int = 4, dropout: float = 0.0):
        super().__init__()
        if decoder != "fixed":
            raise NotImplementedError(f"only the fixed decoder is ported, got decoder={decoder!r}")
        if latents is None:
            raise ValueError("the fixed decoder needs a W+ palette (latents)")
        self.residual = residual
        n_envelopes = hidden_size * n_latent_split + 2 * n_noise
        self.envelopes = EnvelopeReactor(input_mean, input_std, hidden_size=n_envelopes,
                                         num_layers=num_layers, backbone=backbone, dropout=dropout)
        self.decoder = FixedLatentNoiseDecoder(latents, hidden_size, n_latent_split, n_noise,
                                               env_guard_eps=env_guard_eps)

    def forward(self, x, base_noise: list | None = None, generator: torch.Generator | None = None,
                return_envelopes: bool = False):
        envelopes = self.envelopes(x)
        if return_envelopes:
            return envelopes
        latents, noise = self.decoder(envelopes, base_noise=base_noise, generator=generator)
        if self.residual:
            latents = latents - latents.mean(dim=1, keepdim=True)
        return latents, noise

    def load_flax(self, variables: dict) -> "LatentNoiseReactor":
        """Copy a flax ``LatentNoiseReactor``'s variables ({"params": ...}) in."""
        params = variables.get("params", variables)
        self.envelopes.load_flax(params["EnvelopeReactor_0"])
        return self
