"""Sashimi: a U-Net of S4D blocks with temporal pooling.

Counterpart of ``ssar_tpu/models/sashimi.py``: down-pool by p via reshape +
Dense, residual S4 blocks per tier, up-pool (shifted causally by one pooled
frame) with skip connections, a final LayerNorm.  The S4 blocks take kernel
B3 (``ops/vandermonde.py``) on a CUDA tensor, forward and backward.

``SashimiStreamer`` is the O(1)-per-frame recurrent mode: S4 blocks step
their recurrences, DownPools buffer ``pool`` frames and fire at the pooled
rate, UpPools pop from a queue that the deeper tier refills one pooled step
ahead; the queues start as zeros, which is the conv mode's causal shift.
Parameter names follow the flax module (``load_flax``, ``flax_tree``).
"""
from __future__ import annotations

import torch
from torch import nn

from ._flax import FlaxModule
from .s4 import S4Block


class DownPool(FlaxModule):
    """(B, T, H) -> (B, T / p, features) by folding p frames into channels."""

    def __init__(self, in_features: int, features: int, pool: int = 4):
        super().__init__()
        self.proj = nn.Linear(in_features * pool, features)
        self.pool = pool

    def flax_children(self):
        return {"proj": self.proj}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape
        p = self.pool
        return self.proj(x[:, : T // p * p].reshape(B, T // p, p * H))

    def step_pool(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, p, H) -> (B, features): one pooled step."""
        return self.proj(frames.reshape(frames.shape[0], -1))


class UpPool(FlaxModule):
    """(B, T, H) -> (B, T * p, features) by expanding channels into frames,
    shifted right by one pooled step."""

    def __init__(self, in_features: int, features: int, pool: int = 4):
        super().__init__()
        self.proj = nn.Linear(in_features, features * pool)
        self.features, self.pool = features, pool

    def flax_children(self):
        return {"proj": self.proj}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        p = self.pool
        h = self.proj(x).reshape(B, T * p, self.features)
        return torch.cat([h.new_zeros(B, p, self.features), h[:, : T * p - p]], dim=1)

    def step_expand(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, H) -> (B, p, features): the next p output frames."""
        return self.proj(z).reshape(z.shape[0], self.pool, self.features)


class Sashimi(FlaxModule):
    """(B, T, H) -> (B, T, H); T must be divisible by pool ** n_tiers."""

    def __init__(self, features: int, n_layers_per_tier: int = 2, n_tiers: int = 2, pool: int = 4,
                 expand: int = 2, state_dim: int = 64, dropout: float = 0.0):
        super().__init__()
        self.features, self.n_tiers, self.pool, self.expand = features, n_tiers, pool, expand

        def blocks(h):
            return nn.ModuleList(S4Block(h, state_dim, dropout) for _ in range(n_layers_per_tier))

        feats = features
        self.down_blocks, self.up_blocks = nn.ModuleList(), nn.ModuleList()
        self.down_pools, self.up_pools = nn.ModuleList(), nn.ModuleList()
        for _ in range(n_tiers):
            self.down_blocks.append(blocks(feats))
            self.up_blocks.append(blocks(feats))
            self.up_pools.append(UpPool(feats * expand, feats, pool))   # expands INTO this tier's rate
            self.down_pools.append(DownPool(feats, feats * expand, pool))
            feats *= expand
        self.center_blocks = blocks(feats)
        self.out_norm = nn.LayerNorm(features, eps=1e-6)

    def flax_children(self):
        out = {"out_norm": self.out_norm}
        for t in range(self.n_tiers):
            out[f"down_pools_{t}"] = self.down_pools[t]
            out[f"up_pools_{t}"] = self.up_pools[t]
            for i, blk in enumerate(self.down_blocks[t]):
                out[f"down_blocks_{t}_{i}"] = blk
            for i, blk in enumerate(self.up_blocks[t]):
                out[f"up_blocks_{t}_{i}"] = blk
        for i, blk in enumerate(self.center_blocks):
            out[f"center_blocks_{i}"] = blk
        return out

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        skips = []
        for tier in range(self.n_tiers):
            for blk in self.down_blocks[tier]:
                x = blk(x, generator)
            skips.append(x)
            x = self.down_pools[tier](x)
        for blk in self.center_blocks:
            x = blk(x, generator)
        for tier in range(self.n_tiers - 1, -1, -1):
            skip = skips[tier]
            x = self.up_pools[tier](x)[:, : skip.shape[1]] + skip
            for blk in self.up_blocks[tier]:
                x = blk(x, generator)
        return self.out_norm(x)


class SashimiStreamer:
    """O(1)-per-frame streaming evaluation of a Sashimi (in eval mode).

    >>> streamer = SashimiStreamer(model, batch_size=B)
    >>> y_t = streamer.step(x_t)        # x_t (B, H) per frame

    Tier t steps every pool ** t frames.
    """

    def __init__(self, model: Sashimi, batch_size: int):
        self.model, self.B, self.p = model, batch_size, model.pool
        device = model.out_norm.weight.device

        def blk_states(blocks):
            return [blk.init_state((batch_size,)) for blk in blocks]

        nt = model.n_tiers
        self.down_states = [blk_states(model.down_blocks[t]) for t in range(nt)]
        self.up_states = [blk_states(model.up_blocks[t]) for t in range(nt)]
        self.center_states = blk_states(model.center_blocks)
        self.buffers: list[list] = [[] for _ in range(nt)]
        feats = [model.features * model.expand**t for t in range(nt)]
        self.queues = [list(torch.zeros(self.p, batch_size, feats[t], device=device)) for t in range(nt)]

    @staticmethod
    def _step_blocks(blocks, states, x):
        for i, blk in enumerate(blocks):
            states[i], x = blk.step(states[i], x)
        return x

    def _tier_step(self, tier: int, x: torch.Tensor) -> torch.Tensor:
        m = self.model
        x = self._step_blocks(m.down_blocks[tier], self.down_states[tier], x)
        skip = x
        self.buffers[tier].append(x)
        y_up = self.queues[tier].pop(0)
        if len(self.buffers[tier]) == self.p:  # the deeper tiers fire
            z = m.down_pools[tier].step_pool(torch.stack(self.buffers[tier], dim=1))
            self.buffers[tier] = []
            if tier + 1 < m.n_tiers:
                z = self._tier_step(tier + 1, z)
            else:
                z = self._step_blocks(m.center_blocks, self.center_states, z)
            self.queues[tier].extend(m.up_pools[tier].step_expand(z).transpose(0, 1))
        return self._step_blocks(m.up_blocks[tier], self.up_states[tier], y_up + skip)

    @torch.no_grad()
    def step(self, x_t: torch.Tensor) -> torch.Tensor:
        """x_t (B, H) -> y_t (B, H)."""
        return self.model.out_norm(self._tier_step(0, x_t))
