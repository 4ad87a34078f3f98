"""Sequence backbones for the EnvelopeReactor: GRU, LSTM, ConvNeXt, gated MLP,
ALiBi transformer and S4D ("sashimi").

Counterpart of ``ssar_tpu/models/backbones.py``, over (B, L, H):
- ``MultiLayerRNN``: stacked GRUs (``torch.nn.GRU``) or ``VariationalLSTM``s
  with zero initial state;
- ``ConvNeXtSeq2Seq``, ``MLPSeq2Seq``, ``TransformerEncoder`` (pre-LN, an ALiBi
  bias added before a float32 softmax), ``S4Backbone``.
Dropout, drop-path and the LSTM's locked masks draw from the generator passed
to ``forward``, through ``generate/keys.py``'s ``bernoulli``.  Parameter names
follow the flax modules (``load_flax``, ``flax_tree``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..generate import keys
from ._flax import Conv, DenseGeneral, FlaxModule, _arr, _get, attention, dropout, gelu
from .s4 import S4Block

_LSTM_GATES = ("i", "f", "g", "o")   # flax OptimizedLSTMCell's order, as torch's


def _hold_at_zero(module: nn.Module, param: torch.Tensor, n: int) -> None:
    """Keep ``param[:n]`` (a bias flax does not have, zeroed at construction)
    out of training: its gradient is zeroed, so Adam leaves it at zero and
    training moves the parameters optax moves.  The hook is registered once
    per parameter object (again after a deepcopy, which drops tensor hooks)."""
    hooked = module.__dict__.setdefault("_zero_grad_ids", set())
    if id(param) in hooked or not param.requires_grad:
        return
    keep = torch.ones(param.shape[0])
    keep[:n] = 0
    param.register_hook(lambda g: g * keep.to(g.device, g.dtype))
    hooked.add(id(param))


class VariationalLSTM(nn.Module):
    """LSTM with locked dropout: one Bernoulli mask per sequence on the input
    (dropouti), on the recurrent h before every step (dropoutw) and on the
    output (dropouto).  cuDNN's ``nn.LSTM`` cannot apply a recurrent mask, so a
    training run with dropoutw > 0 steps the cell in a loop; otherwise the
    whole sequence goes through ``nn.LSTM``."""

    def __init__(self, in_features: int, features: int, dropouti: float = 0.0, dropoutw: float = 0.0,
                 dropouto: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(in_features, features, batch_first=True)
        with torch.no_grad():   # flax's input kernels have no bias
            self.lstm.bias_ih_l0.zero_()
        self.features = features
        self.dropouti, self.dropoutw, self.dropouto = dropouti, dropoutw, dropouto

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        B, H = x.shape[0], self.features
        _hold_at_zero(self, self.lstm.bias_ih_l0, 4 * H)
        mh = mo = None
        if self.training and (self.dropouti or self.dropoutw or self.dropouto):
            if self.dropouti:
                keep = 1 - self.dropouti
                x = x * keys.bernoulli(generator, keep, (B, 1, x.shape[-1]), x.device) / keep
            if self.dropoutw:
                keep = 1 - self.dropoutw
                mh = keys.bernoulli(generator, keep, (B, H), x.device).to(x.dtype) / keep
            if self.dropouto:
                keep = 1 - self.dropouto
                mo = keys.bernoulli(generator, keep, (B, 1, H), x.device).to(x.dtype) / keep
        if mh is None:
            y = self.lstm(x)[0]
        else:
            y = self._masked_steps(x, mh)
        return y * mo if mo is not None else y

    def _masked_steps(self, x: torch.Tensor, mh: torch.Tensor) -> torch.Tensor:
        lstm = self.lstm
        gx = F.linear(x, lstm.weight_ih_l0, lstm.bias_ih_l0)  # the input half of every step at once
        h = c = x.new_zeros(x.shape[0], self.features)
        ys = []
        for t in range(x.shape[1]):
            gates = gx[:, t] + F.linear(h * mh, lstm.weight_hh_l0, lstm.bias_hh_l0)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1)

    @torch.no_grad()
    def load_flax(self, tree: dict) -> None:
        """flax ``{"OptimizedLSTMCell_0": ...}``: input kernels ii/if/ig/io
        without bias, hidden kernels hi/hf/hg/ho with bias."""
        p = tree["OptimizedLSTMCell_0"]
        self.lstm.weight_ih_l0.copy_(torch.cat([_arr(p[f"i{g}"]["kernel"]).T for g in _LSTM_GATES]))
        self.lstm.weight_hh_l0.copy_(torch.cat([_arr(p[f"h{g}"]["kernel"]).T for g in _LSTM_GATES]))
        self.lstm.bias_ih_l0.zero_()
        self.lstm.bias_hh_l0.copy_(torch.cat([_arr(p[f"h{g}"]["bias"]) for g in _LSTM_GATES]))

    def export_flax(self, grad: bool = False) -> dict:
        """The flax tree; the torch input bias (zero from flax) folds into the
        hidden bias, where its gradient equals the hidden bias's."""
        lstm, H = self.lstm, self.features
        w_ih, w_hh = _get(lstm.weight_ih_l0, grad), _get(lstm.weight_hh_l0, grad)
        b = _get(lstm.bias_hh_l0, grad) if grad else _get(lstm.bias_hh_l0, False) + _get(lstm.bias_ih_l0, False)
        p = {}
        for j, g in enumerate(_LSTM_GATES):
            p[f"i{g}"] = {"kernel": w_ih[j * H:(j + 1) * H].T}
            p[f"h{g}"] = {"kernel": w_hh[j * H:(j + 1) * H].T, "bias": b[j * H:(j + 1) * H]}
        return {"OptimizedLSTMCell_0": p}


class MultiLayerRNN(nn.Module):
    """Stacked GRU (dropout between layers when training) or VariationalLSTM
    (dropouti = dropoutw = dropouto = dropout), batch first."""

    def __init__(self, features: int, num_layers: int = 4, cell: str = "gru", dropout: float = 0.0,
                 in_features: int | None = None):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"unknown cell {cell!r}")
        in_features = features if in_features is None else in_features
        self.cell, self.dropout = cell, dropout
        ins = [in_features] + [features] * (num_layers - 1)
        if cell == "gru":
            self.layers = nn.ModuleList(nn.GRU(n, features, batch_first=True) for n in ins)
            for gru in self.layers:   # flax's GRUCell has no hidden bias on r and z
                with torch.no_grad():
                    gru.bias_hh_l0[: 2 * features].zero_()
        else:
            self.layers = nn.ModuleList(VariationalLSTM(n, features, dropout, dropout, dropout) for n in ins)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                initial_states: list | None = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if self.cell == "lstm":
                x = layer(x, generator)
                continue
            _hold_at_zero(self, layer.bias_hh_l0, 2 * layer.hidden_size)
            h0 = None if initial_states is None else initial_states[i][None].contiguous()
            x = layer(x, h0)[0]
            if i < len(self.layers) - 1:
                x = dropout(x, self.dropout, self.training, generator)
        return x

    @torch.no_grad()
    def load_flax(self, params: dict) -> None:
        """flax ``GRUCell_{i}`` (Dense kernels (in, out)) or ``VariationalLSTM_{i}``.
        A GRUCell has input biases on r, z, n and a hidden bias on n only:
        ``bias_ih = [b_ir, b_iz, b_in]``, ``bias_hh = [0, 0, b_hn]``."""
        for i, layer in enumerate(self.layers):
            if self.cell == "lstm":
                layer.load_flax(params[f"VariationalLSTM_{i}"])
                continue
            p = params[f"GRUCell_{i}"]
            w_ih = np.concatenate([np.asarray(p[g]["kernel"]).T for g in ("ir", "iz", "in")])
            w_hh = np.concatenate([np.asarray(p[g]["kernel"]).T for g in ("hr", "hz", "hn")])
            b_ih = np.concatenate([np.asarray(p[g]["bias"]) for g in ("ir", "iz", "in")])
            b_hn = np.asarray(p["hn"]["bias"])
            b_hh = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
            for name, value in (("weight_ih", w_ih), ("weight_hh", w_hh), ("bias_ih", b_ih), ("bias_hh", b_hh)):
                getattr(layer, f"{name}_l0").copy_(torch.tensor(value))

    def export_flax(self, grad: bool = False) -> dict:
        """The flax tree of the layers (a GRU's r and z hidden biases, absent
        in flax, fold into the input biases)."""
        out = {}
        for i, layer in enumerate(self.layers):
            if self.cell == "lstm":
                out[f"VariationalLSTM_{i}"] = layer.export_flax(grad)
                continue
            H = layer.hidden_size
            w_ih, w_hh = _get(layer.weight_ih_l0, grad), _get(layer.weight_hh_l0, grad)
            b_ih, b_hh = _get(layer.bias_ih_l0, grad), _get(layer.bias_hh_l0, grad)
            if not grad:
                b_ih = b_ih + torch.cat([b_hh[: 2 * H], torch.zeros_like(b_hh[2 * H:])])
            p = {}
            for j, g in enumerate(("r", "z", "n")):
                sl = slice(j * H, (j + 1) * H)
                p[f"i{g}"] = {"kernel": w_ih[sl].T, "bias": b_ih[sl]}
                p[f"h{g}"] = {"kernel": w_hh[sl].T}
            p["hn"]["bias"] = b_hh[2 * H:]
            out[f"GRUCell_{i}"] = p
        return out


def drop_path(h: torch.Tensor, rate: float, training: bool, generator: torch.Generator | None) -> torch.Tensor:
    """One keep / drop per sample, scaled by 1 / keep."""
    if rate <= 0 or not training:
        return h
    keep = 1.0 - rate
    mask = keys.bernoulli(generator, keep, (h.shape[0],) + (1,) * (h.ndim - 1), h.device)
    return h * mask / keep


class ConvNeXtBlock1d(FlaxModule):
    """Depthwise 7-tap SAME conv -> LayerNorm -> Dense(4H) -> GELU -> Dense(H)
    -> layerscale -> drop-path, residual."""

    def __init__(self, features: int, drop_path: float = 0.0):
        super().__init__()
        self.conv = Conv(features, features, 7, groups=features)
        self.norm = nn.LayerNorm(features, eps=1e-6)
        self.fc1 = nn.Linear(features, 4 * features)
        self.fc2 = nn.Linear(4 * features, features)
        self.layerscale = nn.Parameter(torch.full((features,), 1e-6))
        self.drop_path = drop_path

    def flax_children(self):
        return {"Conv_0": self.conv, "LayerNorm_0": self.norm, "Dense_0": self.fc1, "Dense_1": self.fc2,
                "layerscale": self.layerscale}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.fc2(gelu(self.fc1(self.norm(self.conv(x)))))
        return x + drop_path(self.layerscale * h, self.drop_path, self.training, generator)


class ConvNeXtSeq2Seq(FlaxModule):
    def __init__(self, features: int, num_layers: int = 4, drop_path_rate: float = 0.0):
        super().__init__()
        self.blocks = nn.ModuleList(ConvNeXtBlock1d(features, drop_path_rate) for _ in range(num_layers))

    def flax_children(self):
        return {f"ConvNeXtBlock1d_{i}": b for i, b in enumerate(self.blocks)}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, generator)
        return x


class GatedMLPBlock(FlaxModule):
    """LayerNorm -> Dense(2H) -> GELU -> split (u, v) -> u * conv5(LayerNorm(v))
    -> Dense(H) -> dropout, residual."""

    def __init__(self, features: int, dropout: float = 0.0):
        super().__init__()
        self.norm = nn.LayerNorm(features, eps=1e-6)
        self.fc1 = nn.Linear(features, 2 * features)
        self.gate_norm = nn.LayerNorm(features, eps=1e-6)
        self.gate_conv = Conv(features, features, 5)
        self.fc2 = nn.Linear(features, features)
        self.dropout = dropout

    def flax_children(self):
        return {"LayerNorm_0": self.norm, "Dense_0": self.fc1, "LayerNorm_1": self.gate_norm,
                "Conv_0": self.gate_conv, "Dense_1": self.fc2}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        u, v = gelu(self.fc1(self.norm(x))).chunk(2, dim=-1)
        h = self.fc2(u * self.gate_conv(self.gate_norm(v)))
        return x + dropout(h, self.dropout, self.training, generator)


class MLPSeq2Seq(FlaxModule):
    def __init__(self, features: int, num_layers: int = 4, dropout: float = 0.0):
        super().__init__()
        self.blocks = nn.ModuleList(GatedMLPBlock(features, dropout) for _ in range(num_layers))

    def flax_children(self):
        return {f"GatedMLPBlock_{i}": b for i, b in enumerate(self.blocks)}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, generator)
        return x


def alibi_bias(n_heads: int, L: int) -> np.ndarray:
    """ALiBi linear positional bias (heads, L, L), float32."""
    slopes = 2.0 ** (-8.0 * (np.arange(1, n_heads + 1) / n_heads))
    rel = -np.abs(np.arange(L)[None, :] - np.arange(L)[:, None])
    return (slopes[:, None, None] * rel[None]).astype(np.float32)


class _EncoderLayer(nn.Module):
    def __init__(self, features: int, n_heads: int):
        super().__init__()
        head = (n_heads, features // n_heads)
        self.norm1 = nn.LayerNorm(features, eps=1e-6)
        self.q, self.k, self.v = (DenseGeneral((features,), head) for _ in range(3))
        self.o = DenseGeneral(head, (features,))
        self.norm2 = nn.LayerNorm(features, eps=1e-6)
        self.fc1 = nn.Linear(features, 4 * features)
        self.fc2 = nn.Linear(4 * features, features)


class TransformerEncoder(FlaxModule):
    """Pre-LN encoder with an ALiBi bias: per layer x += dropout(attention),
    x += dropout(MLP)."""

    def __init__(self, features: int, num_layers: int = 4, n_heads: int = 4, dropout: float = 0.0):
        super().__init__()
        if features % n_heads:
            raise ValueError(f"features {features} is not a multiple of n_heads {n_heads}")
        self.n_heads, self.dropout = n_heads, dropout
        self.layers = nn.ModuleList(_EncoderLayer(features, n_heads) for _ in range(num_layers))
        self._bias: dict = {}

    def flax_children(self):
        out = {}
        for i, lay in enumerate(self.layers):
            out.update({f"LayerNorm_{2 * i}": lay.norm1, f"DenseGeneral_{4 * i}": lay.q,
                        f"DenseGeneral_{4 * i + 1}": lay.k, f"DenseGeneral_{4 * i + 2}": lay.v,
                        f"DenseGeneral_{4 * i + 3}": lay.o, f"LayerNorm_{2 * i + 1}": lay.norm2,
                        f"Dense_{2 * i}": lay.fc1, f"Dense_{2 * i + 1}": lay.fc2})
        return out

    def bias(self, L: int, device) -> torch.Tensor:
        key = (L, str(device))
        if key not in self._bias:  # one upload a length and device
            self._bias[key] = torch.as_tensor(alibi_bias(self.n_heads, L), device=device)
        return self._bias[key]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        bias = self.bias(x.shape[-2], x.device)
        for lay in self.layers:
            h = lay.norm1(x)
            h = lay.o(attention(lay.q(h), lay.k(h), lay.v(h), bias))
            x = x + dropout(h, self.dropout, self.training, generator)
            h = lay.fc2(gelu(lay.fc1(lay.norm2(x))))
            x = x + dropout(h, self.dropout, self.training, generator)
        return x


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
    "lstm": (lambda h, n, d: MultiLayerRNN(h, n, "lstm", d), "MultiLayerRNN_0"),
    "conv": (lambda h, n, d: ConvNeXtSeq2Seq(h, n, d), "ConvNeXtSeq2Seq_0"),
    "mlp": (lambda h, n, d: MLPSeq2Seq(h, n, d), "MLPSeq2Seq_0"),
    "transformer": (lambda h, n, d: TransformerEncoder(h, n, 4, d), "TransformerEncoder_0"),
    "sashimi": (lambda h, n, d: S4Backbone(h, n, d), "S4Backbone_0"),
}


def make_backbone(name: str, features: int, num_layers: int, dropout: float = 0.0):
    """(module, flax name) of the backbone `name`."""
    name = name.lower()
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}")
    make, flax_name = BACKBONES[name]
    return make(features, num_layers, dropout), flax_name
