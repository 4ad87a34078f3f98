"""S4D — diagonal structured state-space sequence layer.

Counterpart of ``ssar_tpu/models/s4.py``:
- ``s4d_kernel`` (complex, materialises (H, N, L)) and the FFT convolution
  ``s4d_conv`` for the parallel mode;
- ``s4d_step``, the O(1)-per-frame recurrence for streaming.

``S4DLayer`` takes the fused Vandermonde reduction on a CUDA tensor (kernel
B3, ``ops/vandermonde.py``), as the JAX layer takes its Pallas kernel on the
TPU, and the plain complex ``s4d_kernel`` on the CPU.  Init is S4D-Lin:
A_n = -1/2 + i*pi*n, ZOH discretisation.  Parameter names follow the flax
modules, so ``load_flax`` copies a flax tree in by name.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vandermonde import s4d_kernel_fused
from ._flax import FlaxModule, dropout, gelu


def s4d_kernel(log_dt: torch.Tensor, A_re: torch.Tensor, A_im: torch.Tensor, C_re: torch.Tensor,
               C_im: torch.Tensor, L: int) -> torch.Tensor:
    """(H,), (H, N) x4 -> real conv kernel (H, L) via the complex Vandermonde
    contraction.  ZOH: K[l] = 2 Re[C * (exp(dt*A) - 1)/A * exp(dt*A*l)]."""
    dt = torch.exp(log_dt)[:, None]
    A = torch.complex(A_re, A_im)
    C = torch.complex(C_re, C_im)
    dtA = A * dt
    Cb = C * (torch.exp(dtA) - 1.0) / A
    l = torch.arange(L, device=log_dt.device)
    V = torch.exp(dtA[:, :, None] * l[None, None, :])
    K = torch.einsum("hn,hnl->hl", Cb, V)
    return 2.0 * K.real


def s4d_conv(u: torch.Tensor, K: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Causal convolution via FFT: u (..., L, H), K (H, L) -> (..., L, H)."""
    L = u.shape[-2]
    n = 2 * L
    Uf = torch.fft.rfft(u.transpose(-1, -2), n=n)
    Kf = torch.fft.rfft(K, n=n)
    y = torch.fft.irfft(Uf * Kf, n=n)[..., :L]
    return y.transpose(-1, -2) + u * D


def s4d_step(state, u_t, log_dt, A_re, A_im, C_re, C_im, D):
    """One recurrent step.  state: (re, im) pair of (..., H, N) float32;
    u_t (..., H) -> (state', y_t)."""
    s_re, s_im = state
    dt = torch.exp(log_dt)[:, None]
    mag = torch.exp(A_re * dt)
    dA_re = mag * torch.cos(A_im * dt)
    dA_im = mag * torch.sin(A_im * dt)
    denom = A_re**2 + A_im**2
    dB_re = ((dA_re - 1.0) * A_re + dA_im * A_im) / denom
    dB_im = (dA_im * A_re - (dA_re - 1.0) * A_im) / denom
    n_re = s_re * dA_re - s_im * dA_im + dB_re * u_t[..., None]
    n_im = s_re * dA_im + s_im * dA_re + dB_im * u_t[..., None]
    y = 2.0 * (torch.einsum("hn,...hn->...h", C_re, n_re)
               - torch.einsum("hn,...hn->...h", C_im, n_im)) + D * u_t
    return (n_re, n_im), y


class S4DLayer(FlaxModule):
    """Single S4D mixing layer: (B, L, H) -> (B, L, H)."""

    def __init__(self, features: int, state_dim: int = 64, dt_min: float = 1e-3, dt_max: float = 1e-1):
        super().__init__()
        H, N = features, state_dim // 2
        self.features, self.state_dim = features, state_dim
        self.log_dt = nn.Parameter(torch.rand(H) * (np.log(dt_max) - np.log(dt_min)) + np.log(dt_min))
        self.A_re = nn.Parameter(-0.5 * torch.ones(H, N))
        self.A_im = nn.Parameter((np.pi * torch.arange(N, dtype=torch.float32)).expand(H, N).clone())
        self.C_re = nn.Parameter(torch.randn(H, N) * 0.5**0.5)
        self.C_im = nn.Parameter(torch.randn(H, N) * 0.5**0.5)
        self.D = nn.Parameter(torch.ones(H))

    def flax_children(self):
        return {k: getattr(self, k) for k in ("log_dt", "A_re", "A_im", "C_re", "C_im", "D")}

    def _A_re(self) -> torch.Tensor:
        # clamp A_re negative for stability (the reference's exact expression)
        return -torch.exp(torch.log(-torch.clamp(self.A_re, max=-1e-4)))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        L = u.shape[-2]
        A_re = self._A_re()
        if u.is_cuda:  # fused Vandermonde kernel: no (H, N, L) tensor
            K = s4d_kernel_fused(self.log_dt, A_re, self.A_im, self.C_re, self.C_im, L)
        else:
            K = s4d_kernel(self.log_dt, A_re, self.A_im, self.C_re, self.C_im, L)
        return s4d_conv(u, K, self.D)

    def step(self, state, u_t):
        return s4d_step(state, u_t, self.log_dt, self._A_re(), self.A_im, self.C_re, self.C_im, self.D)

    def init_state(self, batch_shape=()):
        z = torch.zeros(*batch_shape, self.features, self.state_dim // 2, device=self.D.device)
        return (z, z)


class S4Block(FlaxModule):
    """Pre-norm residual S4D block with a GLU output:
    x + dropout(glu(out(gelu(s4(norm(x))))))."""

    def __init__(self, features: int, state_dim: int = 64, dropout: float = 0.0):
        super().__init__()
        self.norm = nn.LayerNorm(features, eps=1e-6)  # flax LayerNorm's epsilon
        self.s4 = S4DLayer(features, state_dim)
        self.out = nn.Linear(features, 2 * features)
        self.dropout = dropout

    def flax_children(self):
        return {"norm": self.norm, "s4": self.s4, "out": self.out}

    def forward(self, x, generator: torch.Generator | None = None):
        h = gelu(self.s4(self.norm(x)))
        h = F.glu(self.out(h), dim=-1)
        return x + dropout(h, self.dropout, self.training, generator)

    def step(self, state, x_t):
        """x_t (B, H) -> (state', y_t (B, H))."""
        state, h = self.s4.step(state, self.norm(x_t))
        return state, x_t + F.glu(self.out(gelu(h)), dim=-1)

    def init_state(self, batch_shape=()):
        return self.s4.init_state(batch_shape)
