# Frozen copy of ssar_tpu_torch/generate/noise.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Lazily evaluated noise-module algebra for patch composition.

Counterpart of ``ssar_tpu/generate/noise.py``: the noise of each StyleGAN2
layer is a small expression tree (``Loop`` / ``Blend`` / ``Multiply``
composed by ``Average`` / ``Modulate`` / ``ScaleBias``) evaluated per render
chunk: only ``(i, b)`` frame windows are ever materialised, so a whole
track's full-size noise video never exists in memory.  Banks are tensors on
the device the modulators live on, drawn through ``keys``.  The JAX
package's pytree registration is its own (it passes the trees into one
jitted program) and has no counterpart here.
"""
from __future__ import annotations

import math

import torch

from . import keys
from .latent import linspace


def _win(x: torch.Tensor, i, b: int) -> torch.Tensor:
    """Length-`b` window of `x` along axis 0 starting at `i`, the start
    clamped into [0, len(x) - b] as ``jax.lax.dynamic_slice_in_dim`` does."""
    i = max(0, min(int(i), x.shape[0] - b))
    return x[i : i + b]


class Noise:
    def __init__(self, length: int, size: tuple[int, int]):
        self.length = length
        self.size = size

    def __call__(self, i: int, b: int) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, i: int, b: int) -> torch.Tensor:  # torch-style alias
        return self(i, b)


class Blend(Noise):
    """Two fixed noise banks mixed by the modulating feature (T, M)."""

    def __init__(self, key, length, size, modulator):
        super().__init__(length, size)
        self.noise = keys.normal(key, (2, modulator.shape[1], size[0], size[1]), device=modulator.device)
        self.modulator = modulator

    def __call__(self, i, b):
        mod = _win(self.modulator, i, b).reshape(-1, self.modulator.shape[1])
        left = torch.einsum("MHW,BM->BHW", self.noise[0], mod)
        right = torch.einsum("MHW,BM->BHW", self.noise[1], 1 - mod)
        return left + right


class Multiply(Noise):
    def __init__(self, key, length, size, modulator):
        super().__init__(length, size)
        self.noise = keys.normal(key, (modulator.shape[1], size[0], size[1]), device=modulator.device)
        self.modulator = modulator

    def __call__(self, i, b):
        mod = _win(self.modulator, i, b).reshape(-1, self.modulator.shape[1])
        return torch.einsum("MHW,BM->BHW", self.noise, mod)


class Loop(Noise):
    """Smoothly looping procedural noise."""

    def __init__(self, key, length, size, n_loops: float = 1.0, sigma: float = 5.0, device=None):
        super().__init__(length, size)
        self.sigma = sigma
        self.noise = keys.normal(key, (3, size[0], size[1]), device=device)
        self.idx = linspace(float(n_loops) * 2 * math.pi, length, self.noise.device)

    def __call__(self, i, b):
        freqs = torch.cos(_win(self.idx, i, b)[:, None, None] + self.noise[0:1]) / (self.sigma / 50)
        out = torch.sin(freqs + self.noise[1:2]) * self.noise[2:3]
        rms = torch.sqrt(torch.mean(out**2, dim=(1, 2), keepdim=True))
        return out / (rms + torch.finfo(out.dtype).eps)


class Average(Noise):
    def __init__(self, left, right):
        super().__init__(left.length, left.size)
        self.left, self.right = left, right

    def __call__(self, i, b):
        return (self.left(i, b) + self.right(i, b)) / 2


class Modulate(Noise):
    def __init__(self, left, right, modulator):
        super().__init__(left.length, left.size)
        self.left, self.right = left, right
        self.modulator = modulator.mean(dim=1)  # (T,)

    def __call__(self, i, b):
        mod = _win(self.modulator, i, b)[:, None, None]
        return self.left(i, b) * mod + self.right(i, b) * (1 - mod)


class ScaleBias(Noise):
    def __init__(self, base, scale: float, bias: float):
        super().__init__(base.length, base.size)
        self.base, self.scale, self.bias = base, scale, bias

    def __call__(self, i, b):
        return self.scale * self.base(i, b) + self.bias


NOISE_DEPTH_RANGES = {
    "low": range(0, 6), "mid": range(6, 12), "high": range(12, 17),
    "lowmid": range(0, 12), "midhigh": range(6, 17), "all": range(0, 17),
}


def noise_patch(key, noise, features, tempo, fps, *, patch_type, loop_bars, seq_feat,
                seq_feat_weight, mod_feat, mod_feat_weight, merge_type, merge_depth,
                noise_mean, noise_std):
    """Compose one random noise subpatch over the chosen band of layers."""
    lays = NOISE_DEPTH_RANGES[merge_depth]
    feature = seq_feat_weight * features[seq_feat]
    noise = list(noise)

    for n in lays:
        key, sub = keys.split(key)
        if patch_type == "blend":
            new_noise = Blend(sub, feature.shape[0], noise[n].size, feature)
        elif patch_type == "multiply":
            new_noise = Multiply(sub, feature.shape[0], noise[n].size, feature)
        elif patch_type == "loop":
            n_loops = feature.shape[0] / fps / 60 / tempo / 4 / loop_bars
            new_noise = Loop(sub, feature.shape[0], noise[n].size, n_loops=float(n_loops), device=feature.device)
        else:
            raise ValueError(patch_type)

        if merge_type == "average":
            noise[n] = Average(noise[n], new_noise)
        elif merge_type == "modulate":
            noise[n] = Modulate(noise[n], new_noise, mod_feat_weight * features[mod_feat])
        else:
            noise[n] = new_noise

        noise[n] = ScaleBias(noise[n], scale=noise_std, bias=noise_mean)
    return noise
