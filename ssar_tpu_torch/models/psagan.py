"""PSA-GAN: a progressive self-attention GAN over 1-D latent sequences.

Counterpart of ``ssar_tpu/models/psagan.py``, over (B, T, C): a generator
that grows from T / 2^stage frames by nearest-neighbour upsampling and
residual conv (+ self-attention) blocks, conditioned on time-pooled audio
features, and a discriminator that shrinks the sequence back.  The
generator's noise z is drawn from the key passed to ``forward`` through
``generate/keys.py`` (a test injects JAX's draws there).  Parameter names
follow the flax modules (``load_flax``, ``flax_tree``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..generate import keys
from ._flax import Conv, FlaxModule, MultiHeadDotProductAttention, leaky_relu


class SelfAttention1d(FlaxModule):
    """x + gamma * self-attention(x), gamma a scalar starting at 0."""

    def __init__(self, features: int, n_heads: int = 4):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(features, n_heads, features)
        self.gamma = nn.Parameter(torch.zeros(()))

    def flax_children(self):
        return {"MultiHeadDotProductAttention_0": self.attn, "gamma": self.gamma}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.gamma * self.attn(x, x)


class ConvResidualSelfAttention(FlaxModule):
    """Conv3 -> leaky -> [self-attention] -> conv3 -> leaky, plus x (projected
    by a Dense when its width differs)."""

    def __init__(self, in_features: int, features: int, use_attention: bool = True):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3)
        self.attn = SelfAttention1d(features) if use_attention else None
        self.conv2 = Conv(features, features, 3)
        self.proj = nn.Linear(in_features, features) if in_features != features else None

    def flax_children(self):
        out = {"Conv_0": self.conv1, "Conv_1": self.conv2}
        if self.attn is not None:
            out["SelfAttention1d_0"] = self.attn
        if self.proj is not None:
            out["Dense_0"] = self.proj
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.conv1(x), 0.2)
        if self.attn is not None:
            h = self.attn(h)
        h = leaky_relu(self.conv2(h), 0.2)
        return (x if self.proj is None else self.proj(x)) + h


def _pool_to(c: torch.Tensor, length: int) -> torch.Tensor:
    """Average-pool (B, T, C) over time to `length` frames (T // length each)."""
    B, T, C = c.shape
    f = T // length
    return c[:, : length * f].reshape(B, length, f, C).mean(2)


class ProgressiveGenerator(FlaxModule):
    """(B, T, cond_dim) features + noise -> (B, T, out_dim) sequences, grown
    from T / 2^stage frames; `alpha` < 1 fades the newest block in (build with
    ``fade_in=True`` for that: flax creates the fade Dense only when asked)."""

    def __init__(self, cond_dim: int, out_dim: int = 512, features: int = 64, n_stages: int = 4,
                 noise_dim: int = 32, fade_in: bool = False):
        super().__init__()
        self.features, self.n_stages, self.noise_dim = features, n_stages, noise_dim
        self.inp = nn.Linear(cond_dim + noise_dim, features)
        self.blocks = nn.ModuleList([ConvResidualSelfAttention(features, features, use_attention=False)])
        for s in range(n_stages):
            self.blocks.append(ConvResidualSelfAttention(features + cond_dim, features,
                                                         use_attention=s >= n_stages - 2))
        self.fade = nn.Linear(features, features) if fade_in else None
        self.out = nn.Linear(features, out_dim)

    def flax_children(self):
        out = {"Dense_0": self.inp, **{f"ConvResidualSelfAttention_{i}": b for i, b in enumerate(self.blocks)}}
        if self.fade is not None:
            out["Dense_1"] = self.fade
        out[f"Dense_{1 + (self.fade is not None)}"] = self.out
        return out

    def forward(self, cond: torch.Tensor, key, stage: int | None = None, alpha: float = 1.0) -> torch.Tensor:
        stage = self.n_stages if stage is None else stage
        for s in range(stage):
            if (self.blocks[s + 1].attn is not None) != (s >= stage - 2):
                raise ValueError(f"stage {stage}: block {s + 1} was built for stage {self.n_stages}")
        B, T, _ = cond.shape
        T0 = T // (2**stage) if stage > 0 else T
        z = keys.normal(key, (B, T0, self.noise_dim), device=cond.device).to(cond.dtype)
        h = self.blocks[0](self.inp(torch.cat([_pool_to(cond, T0), z], dim=-1)))
        prev = None
        for s in range(stage):
            prev = h
            h = h.repeat_interleave(2, dim=1)
            h = self.blocks[s + 1](torch.cat([h, _pool_to(cond, h.shape[1])], dim=-1))
            if s == stage - 1 and alpha < 1.0:
                if self.fade is None:
                    raise ValueError("alpha < 1 needs a generator built with fade_in=True")
                h = alpha * h + (1 - alpha) * self.fade(prev.repeat_interleave(2, dim=1))
        return self.out(h)[:, :T]


class ProgressiveDiscriminator(FlaxModule):
    """(B, T, in_dim) sequences + (B, T, cond_dim) features -> (B,) scores."""

    def __init__(self, in_dim: int, cond_dim: int, features: int = 64, n_stages: int = 4):
        super().__init__()
        self.n_stages = n_stages
        self.inp = nn.Linear(in_dim + cond_dim, features)
        self.blocks = nn.ModuleList(ConvResidualSelfAttention(features, features, use_attention=s < 2)
                                    for s in range(n_stages))
        self.pools = nn.ModuleList(nn.Linear(2 * features, features) for _ in range(n_stages))
        self.final = ConvResidualSelfAttention(features, features, use_attention=False)
        self.out = nn.Linear(features, 1)

    def flax_children(self):
        out = {"Dense_0": self.inp, **{f"ConvResidualSelfAttention_{i}": b for i, b in enumerate(self.blocks)}}
        out.update({f"Dense_{1 + i}": p for i, p in enumerate(self.pools)})
        out[f"ConvResidualSelfAttention_{self.n_stages}"] = self.final
        out[f"Dense_{1 + self.n_stages}"] = self.out
        return out

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.inp(torch.cat([x, cond[:, : x.shape[1]]], dim=-1))
        for block, pool in zip(self.blocks, self.pools):
            h = block(h)
            B, T, C = h.shape
            h = pool(h[:, : T // 2 * 2].reshape(B, T // 2, 2 * C))
        return self.out(self.final(h).mean(dim=1))[:, 0]
