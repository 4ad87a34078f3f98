"""Sequence backbones for the EnvelopeReactor: GRU and S4D ("sashimi").

Counterpart of ``ssar_tpu/models/backbones.py``: ``MultiLayerRNN`` with
``cell="gru"`` (stacked GRUs over (B, L, H) with zero initial state, on
``torch.nn.GRU``) and ``S4Backbone`` (S4D blocks and a final LayerNorm).
Dropout draws its masks from the generator passed to ``forward``.  The other
backbones of the JAX package (LSTM, ConvNeXt, gated MLP, transformer) are not
ported yet: ``make_backbone`` raises for them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ._flax import FlaxModule, dropout
from .s4 import S4Block


class MultiLayerRNN(nn.Module):
    """Stacked GRU, batch first; dropout between layers when training."""

    def __init__(self, features: int, num_layers: int = 4, cell: str = "gru", dropout: float = 0.0):
        super().__init__()
        if cell != "gru":
            raise NotImplementedError(f"only the GRU cell is ported, got cell={cell!r} (the LSTM cell is not ported yet)")
        self.layers = nn.ModuleList(nn.GRU(features, features, batch_first=True) for _ in range(num_layers))
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for i, gru in enumerate(self.layers):
            x = gru(x)[0]
            if i < len(self.layers) - 1:
                x = dropout(x, self.dropout, self.training, generator)
        return x

    @torch.no_grad()
    def load_flax(self, params: dict) -> None:
        """Copy flax ``GRUCell_{i}`` params (Dense kernels (in, out)) into the
        torch GRUs.  flax has input biases on r, z, n and a hidden bias on n only:
        ``bias_ih = [b_ir, b_iz, b_in]``, ``bias_hh = [0, 0, b_hn]``."""
        for i, gru in enumerate(self.layers):
            p = params[f"GRUCell_{i}"]
            w_ih = np.concatenate([np.asarray(p[g]["kernel"]).T for g in ("ir", "iz", "in")])
            w_hh = np.concatenate([np.asarray(p[g]["kernel"]).T for g in ("hr", "hz", "hn")])
            b_ih = np.concatenate([np.asarray(p[g]["bias"]) for g in ("ir", "iz", "in")])
            b_hn = np.asarray(p["hn"]["bias"])
            b_hh = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
            for name, value in (("weight_ih", w_ih), ("weight_hh", w_hh), ("bias_ih", b_ih), ("bias_hh", b_hh)):
                getattr(gru, f"{name}_l0").copy_(torch.tensor(value))


class S4Backbone(FlaxModule):
    """num_layers S4D blocks, then LayerNorm."""

    def __init__(self, features: int, num_layers: int = 4, dropout: float = 0.0):
        super().__init__()
        self.blocks = nn.ModuleList(S4Block(features, dropout=dropout) for _ in range(num_layers))
        self.norm = nn.LayerNorm(features, eps=1e-6)

    def flax_children(self):
        return {**{f"S4Block_{i}": b for i, b in enumerate(self.blocks)}, "LayerNorm_0": self.norm}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, generator)
        return self.norm(x)


# backbone key -> (constructor, name of the flax submodule in EnvelopeReactor)
BACKBONES = {
    "gru": (lambda h, n, d: MultiLayerRNN(h, n, "gru", d), "MultiLayerRNN_0"),
    "sashimi": (lambda h, n, d: S4Backbone(h, n, d), "S4Backbone_0"),
}
UNPORTED = ("lstm", "conv", "mlp", "transformer")


def make_backbone(name: str, features: int, num_layers: int, dropout: float = 0.0):
    """(module, flax name) of the backbone `name`."""
    name = name.lower()
    if name in UNPORTED:
        raise NotImplementedError(f"backbone {name!r} is not ported yet: only 'gru' and 'sashimi' are")
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}")
    make, flax_name = BACKBONES[name]
    return make(features, num_layers, dropout), flax_name
