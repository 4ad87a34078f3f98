"""Audio2Latent v1 and v2: the earlier supervised audio -> W+ model family.

Counterpart of ``ssar_tpu/models/audio2latent.py``, over (B, T, F):
- ``Audio2Latent``: a GRU / LSTM or strided-conv autoencoder backbone, an
  optional attention skip branch on the raw features, per-layer-group W+
  heads (dense or temporal conv);
- ``Audio2Latent2``: a temporal U-Net of context-and-correlation layers.
Dropout draws from the generator passed to ``forward`` (``keys.bernoulli``).
Parameter names follow the flax modules (``load_flax``, ``flax_tree``).

flax's ``nn.ConvTranspose(strides=2, padding="SAME")`` does not flip its
kernel and pads as ``lax.conv_transpose`` does, asymmetrically; no symmetric
padding of ``conv_transpose1d`` gives its output.  ``ConvTranspose1d`` here
takes the full transposed convolution of the flipped kernel and crops it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ._flax import Conv, FlaxModule, MultiHeadDotProductAttention, _arr, _get, dropout, leaky_relu
from .backbones import MultiLayerRNN
from .reactor import LayerwiseLinear, Normalize


class AttentionSkip(FlaxModule):
    """Dense -> leaky -> Dense -> leaky -> 4-head self-attention -> leaky,
    dropout after each."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, features)
        self.fc2 = nn.Linear(features, features)
        self.attn = MultiHeadDotProductAttention(features, 4, features, dropout_rate=dropout)
        self.dropout = dropout

    def flax_children(self):
        return {"Dense_0": self.fc1, "Dense_1": self.fc2, "MultiHeadDotProductAttention_0": self.attn}

    def forward(self, x, generator=None):
        h = dropout(leaky_relu(self.fc1(x), 0.2), self.dropout, self.training, generator)
        h = dropout(leaky_relu(self.fc2(h), 0.2), self.dropout, self.training, generator)
        return dropout(leaky_relu(self.attn(h, h, generator), 0.2), self.dropout, self.training, generator)


class ConvTranspose1d(nn.Module):
    """flax ``nn.ConvTranspose(features, (k,), strides=(s,), padding="SAME")``
    over channels-last (B, T, C) -> (B, s T, features): kernel (k, in, out)."""

    def __init__(self, in_features: int, features: int, kernel: int = 5, stride: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(kernel, in_features, features) / (in_features * kernel) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features))
        self.kernel, self.stride = kernel, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, k, s = x.shape[1], self.kernel, self.stride
        w = self.weight.flip(0).permute(1, 2, 0)               # (in, out, k), flipped taps
        full = F.conv_transpose1d(x.transpose(1, 2), w, self.bias, stride=s)   # (T - 1) s + k frames
        # lax.conv_transpose's SAME pads the dilated input by k + s - 2, ceil of half at the start
        pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        start = (k - 1) - pad_a
        return full[:, :, start: start + s * T].transpose(1, 2)

    @torch.no_grad()
    def load_flax(self, tree: dict) -> None:
        self.weight.copy_(_arr(tree["kernel"]))
        self.bias.copy_(_arr(tree["bias"]))

    def export_flax(self, grad: bool = False) -> dict:
        return {"kernel": _get(self.weight, grad), "bias": _get(self.bias, grad)}


class ConvAutoencoder1d(FlaxModule):
    """Strided conv encoder / transposed-conv decoder over time; widths double
    toward the bottleneck; the output padded or trimmed back to T frames."""

    def __init__(self, in_features: int, features: int, num_layers: int = 4, dropout: float = 0.0):
        super().__init__()
        self.layers, self.names = nn.ModuleList(), []
        c_in, n_conv, n_tr = in_features, 0, 0
        for n in range(num_layers):
            out = features * 2 ** min(n, num_layers - n - 1)
            if n >= num_layers // 2:
                self.layers.append(ConvTranspose1d(c_in, out))
                self.names.append(f"ConvTranspose_{n_tr}")
                n_tr += 1
            else:
                self.layers.append(Conv(c_in, out, 5, stride=2))
                self.names.append(f"Conv_{n_conv}")
                n_conv += 1
            c_in = out
        self.dropout = dropout

    def flax_children(self):
        return dict(zip(self.names, self.layers))

    def forward(self, x, generator=None):
        T = x.shape[1]
        for layer in self.layers:
            x = dropout(leaky_relu(layer(x), 0.2), self.dropout, self.training, generator)
        if x.shape[1] < T:
            x = F.pad(x, (0, 0, 0, T - x.shape[1]))
        return x[:, :T]


class LayerwiseConv(FlaxModule):
    """Per-group temporal-conv W+ heads."""

    def __init__(self, in_features: int, out_channels: int = 512, n_outputs: int = 18, n_layerwise: int = 3,
                 kernel_size: int = 5, dropout: float = 0.0):
        super().__init__()
        self.per, self.out_channels = n_outputs // n_layerwise, out_channels
        self.convs = nn.ModuleList()
        for _ in range(n_layerwise):
            self.convs.append(Conv(in_features, out_channels, kernel_size))
            self.convs.append(Conv(out_channels, self.per * out_channels, kernel_size))
        self.dropout = dropout

    def flax_children(self):
        return {f"Conv_{i}": c for i, c in enumerate(self.convs)}

    def forward(self, x, generator=None):
        outs = []
        for first, second in zip(self.convs[::2], self.convs[1::2]):
            h = dropout(leaky_relu(first(x), 0.2), self.dropout, self.training, generator)
            outs.append(second(h).reshape(x.shape[0], x.shape[1], self.per, self.out_channels))
        return torch.cat(outs, dim=2)


class Audio2Latent(FlaxModule):
    """(B, T, F) -> W+ (B, T, n_outputs, output_size)."""

    def __init__(self, input_mean, input_std, hidden_size: int = 64, num_layers: int = 4, n_outputs: int = 18,
                 output_size: int = 512, backbone: str = "gru", skip_backbone: bool = True,
                 layerwise: str = "dense", n_layerwise: int = 3, dropout: float = 0.0):
        super().__init__()
        self.normalize = Normalize(input_mean, input_std)
        F_in = self.normalize.mean.shape[-1]
        if backbone in ("gru", "lstm"):
            self.backbone = MultiLayerRNN(hidden_size, num_layers, backbone, dropout, in_features=F_in)
            self._backbone_name = "MultiLayerRNN_0"
        elif backbone == "conv":
            self.backbone = ConvAutoencoder1d(F_in, hidden_size, num_layers, dropout)
            self._backbone_name = "ConvAutoencoder1d_0"
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        w_in = hidden_size * (2 if skip_backbone else 1)
        self.skip = AttentionSkip(F_in, hidden_size, dropout) if skip_backbone else None
        if layerwise == "dense":
            self.head, self._head_name = LayerwiseLinear(w_in, output_size, n_outputs, n_layerwise, dropout), \
                "LayerwiseLinear_0"
        else:
            self.head, self._head_name = LayerwiseConv(w_in, output_size, n_outputs, n_layerwise,
                                                       dropout=dropout), "LayerwiseConv_0"
        self.dropout = dropout

    def flax_children(self):
        out = {self._backbone_name: self.backbone, self._head_name: self.head}
        if self.skip is not None:
            out["AttentionSkip_0"] = self.skip
        return out

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        w = self.backbone(self.normalize(x), generator)
        w = dropout(leaky_relu(w, 0.2), self.dropout, self.training, generator)
        if self.skip is not None:
            w = torch.cat([w, self.skip(x, generator)], dim=2)
        return self.head(w, generator)


class EfficientChannelAttention(FlaxModule):
    """ECA: a 1-channel conv over the time-mean channel descriptor, a sigmoid gate."""

    def __init__(self, kernel_size: int = 5):
        super().__init__()
        self.conv = Conv(1, 1, kernel_size)

    def flax_children(self):
        return {"Conv_0": self.conv}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv.forward_cf(x.mean(dim=1)[:, None, :])[:, 0]   # (B, C)
        return x * torch.sigmoid(y)[:, None, :]


class ContextAndCorrelationLayer(FlaxModule):
    """A temporal-context path (GRU / LSTM, conv or attention) beside a
    channel-correlation path (Dense, optionally after ECA), concatenated
    (or added)."""

    def __init__(self, in_features: int, context: str = "gru", correlation: str = "linear",
                 out_channels: int = 64, kernel_size: int = 5, dropout: float = 0.0, additive: bool = False):
        super().__init__()
        oc = out_channels if additive else out_channels // 2
        self.context, self.additive, self.dropout = context, additive, dropout
        if context in ("gru", "lstm"):
            self.ctx, self._ctx_name = MultiLayerRNN(oc, 1, context, dropout, in_features=in_features), \
                "MultiLayerRNN_0"
        elif context == "conv":
            self.ctx, self._ctx_name = Conv(in_features, oc, kernel_size), "Conv_0"
        elif context == "transformer":
            self.ctx = MultiHeadDotProductAttention(in_features, 4, oc, oc, dropout_rate=dropout)
            self._ctx_name = "MultiHeadDotProductAttention_0"
        else:
            raise ValueError(f"unknown context {context!r}")
        self.eca = EfficientChannelAttention(kernel_size) if correlation == "eca" else None
        self.corr = nn.Linear(in_features, oc)

    def flax_children(self):
        out = {self._ctx_name: self.ctx, "Dense_0": self.corr}
        if self.eca is not None:
            out["EfficientChannelAttention_0"] = self.eca
        return out

    def forward(self, x, generator=None):
        if self.context in ("gru", "lstm"):
            ctx = self.ctx(x, generator)
        elif self.context == "conv":
            ctx = dropout(self.ctx(x), self.dropout, self.training, generator)
        else:
            ctx = self.ctx(x, x, generator)
        h = x if self.eca is None else self.eca(x)
        corr = dropout(self.corr(h), self.dropout, self.training, generator)
        return ctx + corr if self.additive else torch.cat([ctx, corr], dim=2)


class Audio2Latent2(FlaxModule):
    """Temporal U-Net of context + correlation layers: time pooled by 2 on the
    way down, repeated by 2 on the way up with skips, then per-group W+ heads."""

    def __init__(self, input_mean, input_std, hidden_size: int = 64, num_layers: int = 4, n_outputs: int = 18,
                 output_size: int = 512, context: str = "gru", correlation: str = "linear",
                 n_layerwise: int = 3, dropout: float = 0.0):
        super().__init__()
        H = hidden_size
        self.normalize = Normalize(input_mean, input_std)
        self.inp = nn.Linear(self.normalize.mean.shape[-1], H)
        self.depth = num_layers // 2
        self.layers = nn.ModuleList(ContextAndCorrelationLayer(H, context, correlation, H, dropout=dropout)
                                    for _ in range(2 * self.depth))
        self.down = nn.ModuleList(nn.Linear(2 * H, H) for _ in range(self.depth))
        self.up = nn.ModuleList(nn.Linear(H, H) for _ in range(self.depth))
        self.head = LayerwiseLinear(H, output_size, n_outputs, n_layerwise, dropout)

    def flax_children(self):
        out = {"Dense_0": self.inp, "LayerwiseLinear_0": self.head}
        out.update({f"ContextAndCorrelationLayer_{i}": m for i, m in enumerate(self.layers)})
        out.update({f"Dense_{1 + i}": m for i, m in enumerate(self.down)})
        out.update({f"Dense_{1 + self.depth + i}": m for i, m in enumerate(self.up)})
        return out

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.inp(self.normalize(x))
        downs = []
        for i in range(self.depth):
            h = self.layers[i](h, generator)
            downs.append(h)
            B, T, C = h.shape
            h = self.down[i](h[:, : T // 2 * 2].reshape(B, T // 2, 2 * C))
        for i in range(self.depth):
            h = self.layers[self.depth + i](h, generator).repeat_interleave(2, dim=1)
            skip = downs[self.depth - 1 - i]
            h = self.up[i](h[:, : skip.shape[1]]) + skip
        return self.head(h, generator)
