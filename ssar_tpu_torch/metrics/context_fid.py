"""Frechet Context Distance (FCD) for latent-sequence quality.

Counterpart of ``ssar_tpu/metrics/context_fid.py``: a dilated causal CNN
(the USRLT encoder, Franceschi et al. 2019) embeds windows of latent
sequences, fitted with the time-series triplet loss; the FCD is the Frechet
distance between the embeddings of real and generated sequences.  The
triplet loss's crops draw through ``generate/keys.py`` (``randint``,
``permutation``, ``split``, ``fold_in``), so a test can inject JAX's draws.
Parameter names follow the flax modules (``load_flax``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..generate import keys
from ..models._flax import Conv, FlaxModule, leaky_relu
from ..utils.device import resolve_device
from .ood import frechet_distance


class CausalConvBlock(FlaxModule):
    """Two causal 3-tap convs at `dilation` (left padding 2 * dilation), each
    followed by a leaky ReLU (0.01), plus x (projected by a Dense when its
    width differs)."""

    def __init__(self, in_features: int, features: int, dilation: int):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, dilation=dilation, padding="VALID")
        self.conv2 = Conv(features, features, 3, dilation=dilation, padding="VALID")
        self.proj = nn.Linear(in_features, features) if in_features != features else None
        self.pad = 2 * dilation

    def flax_children(self):
        out = {"Conv_0": self.conv1, "Conv_1": self.conv2}
        if self.proj is not None:
            out["Dense_0"] = self.proj
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, C)
        h = leaky_relu(self.conv1.forward_cf(F.pad(x.transpose(1, 2), (self.pad, 0))))
        h = leaky_relu(self.conv2.forward_cf(F.pad(h, (self.pad, 0)))).transpose(1, 2)
        return (x if self.proj is None else self.proj(x)) + h


class CausalCNNEncoder(FlaxModule):
    """(B, T, D) -> (B, embed_dim): causal blocks at dilations 1, 2, 4, ...,
    the maximum over time, a Dense."""

    def __init__(self, in_features: int, features: int = 64, depth: int = 4, embed_dim: int = 80):
        super().__init__()
        self.blocks = nn.ModuleList(CausalConvBlock(in_features if d == 0 else features, features, 2**d)
                                    for d in range(depth))
        self.out = nn.Linear(features, embed_dim)

    def flax_children(self):
        return {**{f"CausalConvBlock_{d}": b for d, b in enumerate(self.blocks)}, "Dense_0": self.out}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.out(x.amax(dim=1))


def _crops(batch: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    idx = starts[:, None] + torch.arange(length, device=batch.device)
    return torch.gather(batch, 1, idx[..., None].expand(-1, -1, batch.shape[-1]))


def triplet_loss(encode, batch: torch.Tensor, key, n_neg: int = 4, min_len: int = 8) -> torch.Tensor:
    """USRLT's triplet loss: an anchor crop and a positive sub-crop of each
    series against random crops of other series.  `encode` maps (B, L, D) ->
    (B, E)."""
    B, T, _ = batch.shape
    dev = batch.device
    k1, k2, k3, k4 = keys.split(key, 4)
    anchor_len = int(min(T, max(min_len * 2, T // 2)))
    pos_len = anchor_len // 2
    a_start = keys.randint(k1, 0, T - anchor_len + 1, shape=(B,), device=dev)
    p_off = keys.randint(k2, 0, anchor_len - pos_len + 1, shape=(B,), device=dev)
    za = encode(_crops(batch, a_start, anchor_len))
    zp = encode(_crops(batch, a_start + p_off, pos_len))
    loss = -F.logsigmoid((za * zp).sum(dim=1)).mean()
    for i in range(n_neg):
        perm = torch.as_tensor(keys.permutation(keys.fold_in(k3, i), B), device=dev)
        n_start = keys.randint(keys.fold_in(k4, i), 0, T - pos_len + 1, shape=(B,), device=dev)
        zn = encode(_crops(batch[perm], n_start, pos_len))
        loss = loss - F.logsigmoid(-(za * zn).sum(dim=1)).mean() / n_neg
    return loss


def train_encoder(sequences, n_steps: int = 200, lr: float = 1e-3, seed: int = 0, features: int = 32,
                  embed_dim: int = 80, device=None, params: dict | None = None):
    """Fit the context encoder on real latent sequences (N, T, D) with Adam
    on `device` (the CUDA device unless given); returns ``encode``, a function
    of (n, T', D) arrays or tensors -> (n, embed_dim) numpy embeddings.  The initial
    weights come from a CPU generator seeded with `seed`, or from a flax tree
    ``params``."""
    device = resolve_device(device)
    seqs = torch.as_tensor(np.asarray(sequences, np.float32), device=device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enc = CausalCNNEncoder(seqs.shape[-1], features=features, embed_dim=embed_dim)
    if params is not None:
        enc.load_flax(params.get("params", params))
    enc = enc.to(device)
    opt = torch.optim.Adam(enc.parameters(), lr=lr)
    key = keys.PRNGKey(seed + 1)
    for _ in range(n_steps):
        key, sub = keys.split(key)
        loss = triplet_loss(enc, seqs, sub)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    enc.eval()

    @torch.no_grad()
    def encode(x) -> np.ndarray:
        x = x if torch.is_tensor(x) else np.asarray(x, np.float32)
        return enc(torch.as_tensor(x, dtype=torch.float32, device=device)).cpu().numpy()

    return encode


def context_fid(encode, real_sequences, fake_sequences) -> float:
    """FCD: the Frechet distance between the encoded real and generated sequences."""
    return frechet_distance(encode(real_sequences), encode(fake_sequences))
