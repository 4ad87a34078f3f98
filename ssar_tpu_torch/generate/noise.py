"""Lazily evaluated noise-module algebra for patch composition.

Counterpart of ``ssar_tpu/generate/noise.py``: the noise of each StyleGAN2
layer is a small expression tree (``Loop`` / ``Blend`` / ``Multiply``
composed by ``Average`` / ``Modulate`` / ``ScaleBias``) evaluated per render
chunk: only ``(i, b)`` frame windows are ever materialised, so a whole
track's full-size noise video never exists in memory.  Banks are tensors on
the device the modulators live on, drawn through ``keys``.  The JAX
package's pytree registration is its own (it passes the trees into one
jitted program) and has no counterpart here.

Calling one of the six node types evaluates its whole subtree: on a CUDA
card through the noise-tree kernels (``ops/noise_tree_cuda.py``: two
launches a window), from a flat plan built at the first call and kept on the
node; on the CPU by the nodes' eager bodies (``eager``), the plain version.
A node of another type (a user's own ``Noise``) is evaluated by its own call
and enters the kernels as a leaf.  A tree is not changed after its first
call on a card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import noise_tree_cuda
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


def _call(node, i, b):
    return node(i, b)


class _Tree(Noise):
    """The node types the noise-tree kernels evaluate.  ``eager(i, b, call)``
    is a node's plain body, its children evaluated by ``call``."""

    _plan = None   # the subtree's noise_tree_cuda.Plan once called on a card; False on the CPU

    def __call__(self, i, b):
        if self._plan is None:
            device = _device(self)
            self._plan = flatten(self) if device is not None and device.type == "cuda" else False
        if self._plan:
            return noise_tree_cuda.noise_tree_cuda(self._plan, i, b)
        return self.eager(i, b)


class Blend(_Tree):
    """Two fixed noise banks mixed by the modulating feature (T, M)."""

    def __init__(self, key, length, size, modulator):
        super().__init__(length, size)
        self.noise = keys.normal(key, (2, modulator.shape[1], size[0], size[1]), device=modulator.device)
        self.modulator = modulator

    def eager(self, i, b, call=_call):
        mod = _win(self.modulator, i, b).reshape(-1, self.modulator.shape[1])
        left = torch.einsum("MHW,BM->BHW", self.noise[0], mod)
        right = torch.einsum("MHW,BM->BHW", self.noise[1], 1 - mod)
        return left + right


class Multiply(_Tree):
    def __init__(self, key, length, size, modulator):
        super().__init__(length, size)
        self.noise = keys.normal(key, (modulator.shape[1], size[0], size[1]), device=modulator.device)
        self.modulator = modulator

    def eager(self, i, b, call=_call):
        mod = _win(self.modulator, i, b).reshape(-1, self.modulator.shape[1])
        return torch.einsum("MHW,BM->BHW", self.noise, mod)


class Loop(_Tree):
    """Smoothly looping procedural noise."""

    def __init__(self, key, length, size, n_loops: float = 1.0, sigma: float = 5.0, device=None):
        super().__init__(length, size)
        self.sigma = sigma
        self.noise = keys.normal(key, (3, size[0], size[1]), device=device)
        self.idx = linspace(float(n_loops) * 2 * math.pi, length, self.noise.device)

    def eager(self, i, b, call=_call):
        freqs = torch.cos(_win(self.idx, i, b)[:, None, None] + self.noise[0:1]) / (self.sigma / 50)
        out = torch.sin(freqs + self.noise[1:2]) * self.noise[2:3]
        rms = torch.sqrt(torch.mean(out**2, dim=(1, 2), keepdim=True))
        return out / (rms + torch.finfo(out.dtype).eps)


class Average(_Tree):
    def __init__(self, left, right):
        super().__init__(left.length, left.size)
        self.left, self.right = left, right

    def eager(self, i, b, call=_call):
        return (call(self.left, i, b) + call(self.right, i, b)) / 2


class Modulate(_Tree):
    def __init__(self, left, right, modulator):
        super().__init__(left.length, left.size)
        self.left, self.right = left, right
        self.modulator = modulator.mean(dim=1)  # (T,)

    def eager(self, i, b, call=_call):
        mod = _win(self.modulator, i, b)[:, None, None]
        return call(self.left, i, b) * mod + call(self.right, i, b) * (1 - mod)


class ScaleBias(_Tree):
    def __init__(self, base, scale: float, bias: float):
        super().__init__(base.length, base.size)
        self.base, self.scale, self.bias = base, scale, bias

    def eager(self, i, b, call=_call):
        return self.scale * call(self.base, i, b) + self.bias


_KINDS = (Blend, Multiply, Loop, Average, Modulate, ScaleBias)


def eager(node, i, b):
    """`node`'s window evaluated node by node by the eager bodies on the
    tree's own device (the plain version of the noise-tree kernels); a node
    of another type by its own call."""
    return node.eager(i, b, eager) if type(node) in _KINDS else node(i, b)


def _device(node):
    """The device of the first tensor in `node`'s subtree (None if it holds
    none outside opaque nodes)."""
    todo = [node]
    while todo:
        n = todo.pop()
        kind = type(n)
        if kind in (Blend, Multiply, Loop):
            return n.noise.device
        if kind is Modulate:
            return n.modulator.device
        if kind is Average:
            todo += [n.left, n.right]
        elif kind is ScaleBias:
            todo.append(n.base)
    return None


def flatten(root) -> noise_tree_cuda.Plan:
    """`root`'s subtree as the noise-tree kernels' flat plan: each node's
    factor on the way into its parent (1/2 under an Average, the Modulate's
    mod or 1 - mod, the ScaleBias's scale), the leaves and the biases.  Nodes
    of types other than the six (exactly: a subclass may change ``__call__``)
    become opaque leaves."""
    plan = noise_tree_cuda.Plan(size=tuple(int(s) for s in root.size), device=_device(root))
    todo = [(root, -1, noise_tree_cuda.CONST, 1.0, None)]
    while todo:   # pre-order: a parent is numbered before its children
        node, parent, kind, constant, mod = todo.pop()
        n = plan.add_node(parent, kind, constant, mod)
        t = type(node)
        if t is Blend:
            plan.banks.append((n, node.noise.reshape(-1, *node.noise.shape[-2:]), node.modulator, True))
        elif t is Multiply:
            plan.banks.append((n, node.noise, node.modulator, False))
        elif t is Loop:
            plan.loops.append((n, node.noise, node.idx, noise_tree_cuda.loop_inverse(node.sigma)))
        elif t is Average:
            todo += [(node.right, n, noise_tree_cuda.CONST, 0.5, None), (node.left, n, noise_tree_cuda.CONST, 0.5, None)]
        elif t is Modulate:
            todo += [(node.right, n, noise_tree_cuda.ONE_MINUS_MOD, 1.0, node.modulator),
                     (node.left, n, noise_tree_cuda.MOD, 1.0, node.modulator)]
        elif t is ScaleBias:
            plan.biases.append((n, float(np.float32(node.bias))))
            todo.append((node.base, n, noise_tree_cuda.CONST, node.scale, None))
        else:
            plan.opaque.append((n, node))
    return plan


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
