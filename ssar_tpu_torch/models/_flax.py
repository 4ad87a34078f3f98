"""Shared pieces of the port's models: flax-named parameter trees, GELU, dropout.

A ``FlaxModule`` names its children as the flax module it mirrors does
(``flax_children``), so one walker copies a flax parameter tree in
(``load_flax``) and exports the port's parameters, or their gradients, as a
tree of the same shape (``flax_tree``).  Leaf conventions: ``nn.Linear`` <->
``{"kernel": (in, out), "bias"}``, ``nn.LayerNorm`` <-> ``{"scale", "bias"}``,
``nn.Parameter`` <-> the array itself; ``Conv``, ``DenseGeneral`` and the
recurrent layers convert themselves (``load_flax`` / ``export_flax``).
Also flax's multi-head attention, whose softmax runs in float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..generate import keys


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class FlaxModule(nn.Module):
    """A module whose children carry the names of its flax counterpart.  A
    child named ``"*..."`` holds parameters at this module's own level (the
    GRU cells flax names ``GRUCell_i`` beside their parent's Dense layers)."""

    def flax_children(self) -> dict:
        raise NotImplementedError

    def load_flax(self, tree: dict):
        """Copy a flax parameter tree of this module in; returns self."""
        load_flax(self, tree)
        return self


def dropout(x: torch.Tensor, rate: float, training: bool, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by 1 / keep,
    the mask drawn from `generator` (the default generator when None) through
    ``keys.bernoulli``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keys.bernoulli(generator, keep, x.shape, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """flax ``nn.leaky_relu`` (default slope 0.01)."""
    return F.leaky_relu(x, slope)


def same_pad(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """x (B, C, T) padded along T as XLA pads ``padding="SAME"``: the output
    has ceil(T / stride) frames, the extra padding at the end."""
    T = x.shape[-1]
    out = -(-T // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - T, 0)
    return F.pad(x, (total // 2, total - total // 2))


class Conv(nn.Module):
    """flax ``nn.Conv`` over the last axis of channels-last input, with
    ``padding="SAME"`` (or "VALID"), stride, dilation and groups: kernel
    (k..., in / groups, out) <-> torch (out, in / groups, k...).  Runs the
    torch convolution of the matching rank on channels-first data."""

    def __init__(self, in_features: int, features: int, kernel_size, stride: int = 1, dilation: int = 1,
                 groups: int = 1, padding: str = "SAME"):
        super().__init__()
        self.kernel_size = tuple(kernel_size) if isinstance(kernel_size, (tuple, list)) else (kernel_size,)
        self.stride, self.dilation, self.groups, self.padding = stride, dilation, groups, padding
        fan_in = in_features // groups * int(np.prod(self.kernel_size))
        self.weight = nn.Parameter(torch.randn(features, in_features // groups, *self.kernel_size) / fan_in**0.5)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-first x (B, C, spatial...)."""
        nd = len(self.kernel_size)
        if self.padding == "SAME":
            if nd == 1:
                x = same_pad(x, self.kernel_size[0], self.stride, self.dilation)
                pad = 0
            elif self.stride == 1 and self.dilation == 1 and all(k % 2 for k in self.kernel_size):
                pad = tuple(k // 2 for k in self.kernel_size)
            else:
                raise ValueError("SAME padding for strided or even kernels is 1-D only")
        else:
            pad = 0
        conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
        return conv(x, self.weight, self.bias, self.stride, pad, self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last x (B, spatial..., C), as flax takes it."""
        return self.forward_cf(x.movedim(-1, 1)).movedim(1, -1)

    @torch.no_grad()
    def load_flax(self, tree: dict) -> None:
        k = _arr(tree["kernel"])
        self.weight.copy_(k.permute(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))
        self.bias.copy_(_arr(tree["bias"]))

    def export_flax(self, grad: bool = False) -> dict:
        w = _get(self.weight, grad)
        return {"kernel": w.permute(*range(2, w.ndim), 1, 0), "bias": _get(self.bias, grad)}


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` from `in_shape` trailing axes to `out_shape`
    (kernel in_shape + out_shape, bias out_shape), one matrix product."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        n_in, n_out = int(np.prod(self.in_shape)), int(np.prod(self.out_shape))
        self.weight = nn.Parameter(torch.randn(n_out, n_in) / n_in**0.5)
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.ndim - len(self.in_shape)]
        y = F.linear(x.reshape(*lead, -1), self.weight, self.bias)
        return y.reshape(*lead, *self.out_shape)

    @torch.no_grad()
    def load_flax(self, tree: dict) -> None:
        self.weight.copy_(_arr(tree["kernel"]).reshape(self.weight.shape[1], -1).T)
        self.bias.copy_(_arr(tree["bias"]).reshape(-1))

    def export_flax(self, grad: bool = False) -> dict:
        return {"kernel": _get(self.weight, grad).T.reshape(*self.in_shape, *self.out_shape),
                "bias": _get(self.bias, grad).reshape(self.out_shape)}


def attention_weights(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor | None = None, dropout_rate: float = 0.0,
                      training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``dot_product_attention_weights`` for q (..., Lq, heads, d), k
    (..., Lk, heads, d): softmax of (q / sqrt(d)) k^T + bias in float32
    (..., heads, Lq, Lk); attention dropout, when training, broadcast over
    the batch and the heads as flax draws it."""
    q = q / float(np.sqrt(q.shape[-1]))
    w = torch.einsum("...qhd,...khd->...hqk", q, k)
    if bias is not None:
        w = w + bias
    w = torch.softmax(w.float(), dim=-1).to(q.dtype)
    if training and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        mask = keys.bernoulli(generator, keep, (1,) * (k.ndim - 2) + tuple(w.shape[-2:]), w.device)
        w = w * (mask.to(w.dtype) / keep)
    return w


def attention(q, k, v, bias=None, dropout_rate: float = 0.0, training: bool = False, generator=None):
    """flax ``dot_product_attention``: (..., Lq, heads, d) out."""
    w = attention_weights(q, k, bias, dropout_rate, training, generator)
    return torch.einsum("...hqk,...khd->...qhd", w, v)


class MultiHeadDotProductAttention(FlaxModule):
    """flax ``nn.MultiHeadDotProductAttention`` (self- or cross-attention):
    ``query``, ``key``, ``value`` DenseGeneral (in, heads, qkv / heads) and
    ``out`` (heads, qkv / heads, out_features)."""

    def __init__(self, in_features: int, num_heads: int, qkv_features: int | None = None,
                 out_features: int | None = None, dropout_rate: float = 0.0):
        super().__init__()
        qkv = qkv_features or in_features
        if qkv % num_heads:
            raise ValueError(f"qkv_features {qkv} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        head = (num_heads, qkv // num_heads)
        self.query = DenseGeneral((in_features,), head)
        self.key = DenseGeneral((in_features,), head)
        self.value = DenseGeneral((in_features,), head)
        self.out = DenseGeneral(head, (out_features or in_features,))

    def flax_children(self):
        return {"query": self.query, "key": self.key, "value": self.value, "out": self.out}

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x_kv = x_q if x_kv is None else x_kv
        a = attention(self.query(x_q), self.key(x_kv), self.value(x_kv), None, self.dropout_rate,
                      self.training, generator)
        return self.out(a)


def _arr(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, dtype=np.float32))  # a copy: flax leaves are read-only arrays


def _get(p: torch.Tensor, grad: bool) -> torch.Tensor:
    return (p.grad if grad else p).detach()


@torch.no_grad()
def load_flax(obj, tree) -> None:
    if isinstance(obj, nn.Parameter):
        if tuple(obj.shape) != tuple(np.shape(tree)):
            raise ValueError(f"flax leaf of shape {np.shape(tree)} for a parameter of shape {tuple(obj.shape)}")
        obj.copy_(_arr(tree))
    elif isinstance(obj, nn.Linear):
        obj.weight.copy_(_arr(tree["kernel"]).T)
        obj.bias.copy_(_arr(tree["bias"]))
    elif isinstance(obj, nn.LayerNorm):
        obj.weight.copy_(_arr(tree["scale"]))
        obj.bias.copy_(_arr(tree["bias"]))
    elif isinstance(obj, FlaxModule):
        for name, child in obj.flax_children().items():
            load_flax(child, tree if name.startswith("*") else tree[name])
    else:  # a module with its own converter (convolutions, DenseGeneral, recurrent layers)
        obj.load_flax(tree)


def flax_tree(obj, grad: bool = False):
    """The parameters (or, with ``grad``, their gradients) of `obj` as a
    flax-shaped tree of detached tensors."""
    if isinstance(obj, nn.Parameter):
        return _get(obj, grad)
    if isinstance(obj, nn.Linear):
        return {"kernel": _get(obj.weight, grad).T, "bias": _get(obj.bias, grad)}
    if isinstance(obj, nn.LayerNorm):
        return {"scale": _get(obj.weight, grad), "bias": _get(obj.bias, grad)}
    if isinstance(obj, FlaxModule):
        out = {}
        for name, child in obj.flax_children().items():
            if name.startswith("*"):
                out.update(flax_tree(child, grad))
            else:
                out[name] = flax_tree(child, grad)
        return out
    if hasattr(obj, "export_flax"):
        return obj.export_flax(grad)
    raise NotImplementedError(f"no flax tree export for {type(obj).__name__}")
