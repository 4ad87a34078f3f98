"""Plain LatentNoiseReactor (GRU backbone, fixed decoder): features -> W+
latents and the 4-level noise pyramid.

Written from the equations: a standardisation, Linear + tanh-GELU, a stack
of GRU layers stepped one frame at a time (torch's gate order r, z, n and
its ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``), GELU + Linear; each
of the palette's splits mixes its rows by its envelopes over their sum, the
noise envelopes scale time-smoothed normal noise, and the latents are
centred over time.  Weights are the ``state_dict`` names of the port's
module, which the benchmark draws from the seed and hands to both.
"""
from __future__ import annotations

import math

import torch

from .frozen.ops.gaussian import gaussian_filter


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _gru(x: torch.Tensor, sd: dict, prefix: str, dtype) -> torch.Tensor:
    """One GRU layer over (T, H_in) from a zero state, in `dtype`."""
    w_ih, w_hh = sd[prefix + "weight_ih_l0"].to(dtype), sd[prefix + "weight_hh_l0"].to(dtype)
    b_ih, b_hh = sd[prefix + "bias_ih_l0"].to(dtype), sd[prefix + "bias_hh_l0"].to(dtype)
    H = w_hh.shape[1]
    gi = x.to(dtype) @ w_ih.T + b_ih                      # (T, 3H), all frames at once
    h = torch.zeros(H, dtype=dtype, device=x.device)
    out = torch.empty(x.shape[0], H, dtype=dtype, device=x.device)
    for t in range(x.shape[0]):
        gh = w_hh @ h + b_hh
        r = torch.sigmoid(gi[t, :H] + gh[:H])
        z = torch.sigmoid(gi[t, H:2 * H] + gh[H:2 * H])
        n = torch.tanh(gi[t, 2 * H:] + r * gh[2 * H:])
        h = (1 - z) * n + z * h
        out[t] = h
    return out


def envelopes(features: torch.Tensor, sd: dict, num_layers: int, dtype=torch.float32) -> torch.Tensor:
    """(T, F) features -> (T, E) envelopes."""
    p = "envelopes."
    x = (features - sd[p + "normalize.mean"]) / (sd[p + "normalize.std"] + 1e-8)
    x = _gelu(x.to(dtype) @ sd[p + "inp.weight"].to(dtype).T + sd[p + "inp.bias"].to(dtype))
    for i in range(num_layers):
        x = _gru(x, sd, f"{p}backbone.layers.{i}.", dtype)
    return (_gelu(x) @ sd[p + "out.weight"].to(dtype).T + sd[p + "out.bias"].to(dtype)).float()


def smoothed_noise(T: int, size: int, generator: torch.Generator) -> torch.Tensor:
    """(T, size, size) normal noise drawn as (T, 1, size, size) from `generator`
    on its device, smoothed along time by a gaussian of std 5 frames with
    circular padding."""
    n = torch.randn((T, 1, size, size), generator=generator, device=generator.device)
    return gaussian_filter(n, 5.0)[:, 0]


def react(features: torch.Tensor, sd: dict, palette: torch.Tensor, *, hidden: int, n_split: int, n_noise: int,
          num_layers: int, generator: torch.Generator, dtype=torch.float32):
    """-> latents (T, n_ws, 512) and noise maps [(T, 1, s, s)] for s = 4, 8, ..."""
    env = envelopes(features, sd, num_layers, dtype)
    T = env.shape[0]
    rows = palette.shape[1] // n_split
    parts = []
    for i in range(n_split):
        e = env[:, i * hidden:(i + 1) * hidden]
        e = e / e.sum(dim=-1, keepdim=True)
        lat = palette[i * hidden:(i + 1) * hidden, i * rows:(i + 1) * rows]
        parts.append(torch.einsum("th,hwl->twl", e, lat))
    latents = torch.cat(parts, dim=1)
    latents = latents - latents.mean(dim=0, keepdim=True)
    ne = env[:, n_split * hidden:]
    noise = []
    for i in range(n_noise):
        base = smoothed_noise(T, 2 ** (i + 2), generator).to(env.device)
        noise.append((ne[:, 2 * i, None, None] + ne[:, 2 * i + 1, None, None] * base)[:, None])
    return latents, noise


def duplicate_pyramid(noise: list, n_layers: int) -> list:
    """[n0, n1, ..., nk] -> [n0, n1, n1, n2, n2, ...] padded with None to `n_layers`."""
    dup = [noise[0]] + [n for nn in noise[1:] for n in (nn, nn)]
    return (dup + [None] * n_layers)[:n_layers]
