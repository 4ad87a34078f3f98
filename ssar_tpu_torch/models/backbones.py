"""Sequence backbones for the EnvelopeReactor — the GRU path.

Counterpart of the GRU path of ``ssar_tpu/models/backbones.py``
(``MultiLayerRNN`` with ``cell="gru"``): stacked GRUs over (B, L, H) with
zero initial state, on ``torch.nn.GRU``.  The other backbones are not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class MultiLayerRNN(nn.Module):
    """Stacked GRU, batch first; dropout between layers when training."""

    def __init__(self, features: int, num_layers: int = 4, cell: str = "gru", dropout: float = 0.0):
        super().__init__()
        if cell != "gru":
            raise NotImplementedError(f"only the GRU backbone is ported, got cell={cell!r}")
        self.rnn = nn.GRU(features, features, num_layers=num_layers, batch_first=True,
                          dropout=dropout if num_layers > 1 else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)[0]

    @torch.no_grad()
    def load_flax(self, params: dict) -> None:
        """Copy flax ``GRUCell_{i}`` params (Dense kernels (in, out)) into the
        torch GRU.  flax has input biases on r, z, n and a hidden bias on n only:
        ``bias_ih = [b_ir, b_iz, b_in]``, ``bias_hh = [0, 0, b_hn]``."""
        for i in range(self.rnn.num_layers):
            p = params[f"GRUCell_{i}"]
            w_ih = np.concatenate([np.asarray(p[g]["kernel"]).T for g in ("ir", "iz", "in")])
            w_hh = np.concatenate([np.asarray(p[g]["kernel"]).T for g in ("hr", "hz", "hn")])
            b_ih = np.concatenate([np.asarray(p[g]["bias"]) for g in ("ir", "iz", "in")])
            b_hn = np.asarray(p["hn"]["bias"])
            b_hh = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
            for name, value in (("weight_ih", w_ih), ("weight_hh", w_hh), ("bias_ih", b_ih), ("bias_hh", b_hh)):
                getattr(self.rnn, f"{name}_l{i}").copy_(torch.tensor(value))
