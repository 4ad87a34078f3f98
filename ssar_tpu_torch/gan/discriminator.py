"""StyleGAN2 discriminator and a pSp-style W+ encoder (image -> latent).

Counterpart of ``ssar_tpu/gan/discriminator.py`` in NCHW: residual
downsampling blocks of equalized-lr convolutions (the weight scaled by
1 / sqrt(fan_in) at run time), minibatch standard deviation (group 4), and
``PSPEncoder``'s per-W+-row heads on the same trunk.  Images come in as the
JAX package's (B, R, R, 3) and go through the network as (B, 3, R, R).
Parameter names follow the flax modules: ``load_flax`` takes the JAX
package's tree (HWIO kernels ``weight``) and ``flax_tree`` gives it back.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models._flax import FlaxModule, _arr, _get
from ..ops.upfirdn import downsample2x, fused_leaky_relu


class EqualConv(nn.Module):
    """k x k conv, padding k // 2, weight * 1 / sqrt(cin k^2), then fused
    bias + leaky ReLU (or the bias alone)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, activate: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(features, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = 1.0 / np.sqrt(in_channels * kernel**2)
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x, self.weight * self.scale, padding=self.weight.shape[-1] // 2)
        if self.activate:
            return fused_leaky_relu(out, self.bias)
        return out + self.bias[:, None, None]

    @torch.no_grad()
    def load_flax(self, tree: dict) -> None:
        self.weight.copy_(_arr(tree["weight"]).permute(3, 2, 0, 1))   # HWIO -> OIHW
        self.bias.copy_(_arr(tree["bias"]))

    def export_flax(self, grad: bool = False) -> dict:
        return {"weight": _get(self.weight, grad).permute(2, 3, 1, 0), "bias": _get(self.bias, grad)}


class DiscriminatorBlock(FlaxModule):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = EqualConv(in_channels, in_channels)
        self.conv2 = EqualConv(in_channels, features)
        self.skip = EqualConv(in_channels, features, kernel=1, activate=False)

    def flax_children(self):
        return {"EqualConv_0": self.conv1, "EqualConv_1": self.conv2, "EqualConv_2": self.skip}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(downsample2x(self.conv1(x)))
        return (h + self.skip(downsample2x(x))) / np.sqrt(2)


def minibatch_stddev(x: torch.Tensor, group: int = 4) -> torch.Tensor:
    """(B, C, H, W) -> (B, C + 1, H, W): the std over g = min(group, B) slices
    of the batch, averaged over C, H, W, as one more channel; sample b takes
    column b // g's statistic, as the reference repeats it.  B must be a
    multiple of g, as in the reference."""
    B, C, H, W = x.shape
    g = min(group, B)
    if B % g:
        raise ValueError(f"batch {B} is not a multiple of the stddev group {g}")
    y = x.reshape(g, -1, C, H, W)
    std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8).mean(dim=(1, 2, 3)).repeat_interleave(g)
    return torch.cat([x, std[:, None, None, None].expand(B, 1, H, W)], dim=1)


_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}


class Discriminator(FlaxModule):
    """(B, R, R, 3) -> (B,) realness scores; ``features=True`` returns the
    (B, 512) penultimate activations instead."""

    def __init__(self, resolution: int = 256, channel_multiplier: int = 2):
        super().__init__()
        chans = {r: c * (channel_multiplier if r >= 64 else 1) for r, c in _CHANNELS.items()}
        log = int(np.log2(resolution))
        self.from_rgb = EqualConv(3, chans[resolution], kernel=1)
        self.blocks = nn.ModuleList()
        c_in = chans[resolution]
        for i in range(log, 2, -1):
            self.blocks.append(DiscriminatorBlock(c_in, chans[2 ** (i - 1)]))
            c_in = chans[2 ** (i - 1)]
        self.final_conv = EqualConv(c_in + 1, chans[4])
        self.fc = nn.Linear(chans[4] * 16, chans[4])
        self.out = nn.Linear(chans[4], 1)

    def flax_children(self):
        return {"EqualConv_0": self.from_rgb, **{f"DiscriminatorBlock_{i}": b for i, b in enumerate(self.blocks)},
                "EqualConv_1": self.final_conv, "Dense_0": self.fc, "Dense_1": self.out}

    @torch.no_grad()
    def load_flax(self, tree: dict) -> "Discriminator":
        """The JAX package's tree; the flattening Dense's rows go from (H, W, C)
        order to the port's (C, H, W)."""
        tree = dict(tree.get("params", tree))
        k = np.asarray(tree["Dense_0"]["kernel"])
        C = self.final_conv.weight.shape[0]
        tree["Dense_0"] = {"kernel": k.reshape(4, 4, C, -1).transpose(2, 0, 1, 3).reshape(16 * C, -1),
                           "bias": tree["Dense_0"]["bias"]}
        return super().load_flax(tree)

    def forward(self, x: torch.Tensor, features: bool = False) -> torch.Tensor:
        h = self.from_rgb(x.permute(0, 3, 1, 2))
        for block in self.blocks:
            h = block(h)
        h = self.final_conv(minibatch_stddev(h))
        h = fused_leaky_relu(self.fc(h.reshape(h.shape[0], -1)))
        return h if features else self.out(h)[:, 0]


def discriminator_flax_tree(D: Discriminator, grad: bool = False) -> dict:
    """The JAX package's tree of `D` (or of its gradients)."""
    from ..models._flax import flax_tree

    tree = flax_tree(D, grad)
    k = tree["Dense_0"]["kernel"]
    C = D.final_conv.weight.shape[0]
    tree["Dense_0"]["kernel"] = k.reshape(C, 4, 4, -1).permute(1, 2, 0, 3).reshape(16 * C, -1)
    return tree


class PSPEncoder(FlaxModule):
    """(B, R, R, 3) -> W+ (B, n_styles, 512): a shared conv trunk with taps at
    its deepest, middle and shallowest levels feeding map2style heads for the
    coarse, medium and fine W+ groups."""

    def __init__(self, n_styles: int = 18, resolution: int = 256):
        super().__init__()
        self.stem = EqualConv(3, 64)
        self.blocks = nn.ModuleList()
        c, res, chans = 64, resolution, []
        while res > 4:
            c_out = min(512, c * 2)
            self.blocks.append(DiscriminatorBlock(c, c_out))
            c, res = c_out, res // 2
            chans.append((c, res))
        n_c = n_styles // 3
        taps = [len(chans) - 1, max(0, len(chans) - 2), max(0, len(chans) - 3)]
        counts = [n_c, n_c, n_styles - 2 * n_c]
        self.taps = [t for t, n in zip(taps, counts) for _ in range(n)]
        self.heads = nn.ModuleList()
        self.head_convs = []   # flax names of each head's convs, in creation order
        for t in self.taps:
            c, res = chans[t]
            convs = nn.ModuleList()
            while res > 1:
                convs.append(EqualConv(c, 512))
                c, res = 512, res // 2
            self.heads.append(nn.ModuleDict({"convs": convs, "fc": nn.Linear(c, 512)}))

    def flax_children(self):
        out = {"EqualConv_0": self.stem, **{f"DiscriminatorBlock_{i}": b for i, b in enumerate(self.blocks)}}
        n_conv = 1
        for i, head in enumerate(self.heads):
            for conv in head["convs"]:
                out[f"EqualConv_{n_conv}"] = conv
                n_conv += 1
            out[f"Dense_{i}"] = head["fc"]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x.permute(0, 3, 1, 2))
        feats = []
        for block in self.blocks:
            h = block(h)
            feats.append(h)
        styles = []
        for t, head in zip(self.taps, self.heads):
            g = feats[t]
            for conv in head["convs"]:
                g = conv(downsample2x(g))
            styles.append(head["fc"](g.reshape(g.shape[0], -1)))
        return torch.stack(styles, dim=1)
