"""Shared pieces of the port's models: flax-named parameter trees, GELU, dropout.

A ``FlaxModule`` names its children as the flax module it mirrors does
(``flax_children``), so one walker copies a flax parameter tree in
(``load_flax``) and exports the port's parameters, or their gradients, as a
tree of the same shape (``flax_tree``).  Leaf conventions: ``nn.Linear`` <->
``{"kernel": (in, out), "bias"}``, ``nn.LayerNorm`` <-> ``{"scale", "bias"}``,
``nn.Parameter`` <-> the array itself.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, training: bool, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by 1 / keep,
    the mask drawn from `generator` (the default generator when None)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class FlaxModule(nn.Module):
    """A module whose children carry the names of its flax counterpart."""

    def flax_children(self) -> dict:
        raise NotImplementedError

    def load_flax(self, tree: dict):
        """Copy a flax parameter tree of this module in; returns self."""
        load_flax(self, tree)
        return self


def _arr(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, dtype=np.float32))  # a copy: flax leaves are read-only arrays


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
            load_flax(child, tree[name])
    else:  # a module with its own converter (the GRU)
        obj.load_flax(tree)


def flax_tree(obj, grad: bool = False):
    """The parameters (or, with ``grad``, their gradients) of `obj` as a
    flax-shaped tree of detached tensors."""
    def get(p):
        return (p.grad if grad else p).detach()

    if isinstance(obj, nn.Parameter):
        return get(obj)
    if isinstance(obj, nn.Linear):
        return {"kernel": get(obj.weight).T, "bias": get(obj.bias)}
    if isinstance(obj, nn.LayerNorm):
        return {"scale": get(obj.weight), "bias": get(obj.bias)}
    if isinstance(obj, FlaxModule):
        return {name: flax_tree(child, grad) for name, child in obj.flax_children().items()}
    raise NotImplementedError(f"no flax tree export for {type(obj).__name__}")
