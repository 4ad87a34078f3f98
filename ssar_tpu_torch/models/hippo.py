"""HiPPO (High-order Polynomial Projection Operators) timeseries parameterization.

Counterpart of ``ssar_tpu/models/hippo.py``: a whole envelope timeseries is
represented by N Legendre coefficients per envelope; decoding is one
(L, N) x (N, C) product, so the test-time optimizer tunes a compact spectral
parameterization instead of raw frames.  Standard HiPPO formulas (Gu et al.
2020).

The LegS per-step bilinear discretisations ``A_t``, ``B_t`` are built on the
device by the reference's structured forward substitution, but in float64 and
rounded to float32 once at the end (the reference runs it in float32); the
encode recurrence and the decode product run in float32 with TF32 off.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from scipy import signal as ssignal
from scipy import special as ss

from ..utils.device import full_precision, resolve_device


def transition(measure: str, N: int):
    """Continuous-time HiPPO transition (A, B): 'lmu' (LegT) or 'legs'."""
    if measure == "lmu":
        Q = np.arange(N, dtype=np.float64)
        R = (2 * Q + 1)[:, None]
        j, i = np.meshgrid(Q, Q)
        A = np.where(i < j, -1.0, (-1.0) ** (i - j + 1)) * R
        B = ((-1.0) ** Q[:, None]) * R
    elif measure == "legs":
        q = np.arange(N, dtype=np.float64)
        col, row = np.meshgrid(q, q)
        r = 2 * q + 1
        M = -(np.where(row >= col, r, 0) - np.diag(q))
        T = np.sqrt(np.diag(2 * q + 1))
        A = T @ M @ np.linalg.inv(T)
        B = np.diag(T)[:, None]
    else:
        raise ValueError(measure)
    return A, B


@lru_cache(maxsize=8)
def init_leg_t(N: int, dt: float = 1.0):
    """Time-invariant LegT (LMU) discretisation + Legendre evaluation matrix
    (numpy float32: Ad (N, N), Bd (N,), E (1/dt, N))."""
    A, B = transition("lmu", N)
    C = np.ones((1, N))
    D = np.zeros((1,))
    Ad, Bd, *_ = ssignal.cont2discrete((A, B, C, D), dt=dt, method="bilinear")
    vals = np.arange(0.0, 1.0, dt)
    E = ss.eval_legendre(np.arange(N)[:, None], 1 - 2 * vals).T
    return Ad.astype(np.float32), Bd.squeeze(-1).astype(np.float32), E.astype(np.float32)


@lru_cache(maxsize=4)
def _init_leg_s(N: int, max_length: int, device: torch.device):
    # A = T M T^-1 with T = sqrt(diag(2q + 1)) and M lower triangular, so
    #   A_t = (I - A/2t)^-1 (I + A/2t) = T (2tI - M)^-1 (2tI + M) T^-1
    #   B_t = (I - A/2t)^-1 B/t       = T (2tI - M)^-1 2·1
    # need triangular solves only.  L = 2tI - M has the diagonal 2t + i + 1 and
    # the row-independent strict lower part L[i, j] = 2j + 1, so forward
    # substitution keeps one running inner product per right-hand side: N
    # sequential rank-1 updates of a (steps, N + 1) carry, every step of a
    # batch and every right-hand side at once.
    f64 = dict(dtype=torch.float64, device=device)
    q = torch.arange(N, **f64)
    r = 2 * q + 1
    M = -(torch.tril(r.expand(N, N)) - torch.diag(q))
    Td = torch.sqrt(r)
    eye = torch.eye(N, **f64)
    A_out = torch.empty(max_length, N, N, dtype=torch.float32, device=device)
    B_out = torch.empty(max_length, N, dtype=torch.float32, device=device)
    bs = 256  # steps per batch: bounds the float64 scratch at (bs, N, N + 1)
    for start in range(0, max_length, bs):
        t = torch.arange(start + 1, min(start + bs, max_length) + 1, **f64)
        R = torch.cat([2 * t[:, None, None] * eye + M, torch.full((len(t), N, 1), 2.0, **f64)], dim=2)
        diag = 2 * t[:, None] + q[None, :] + 1.0
        X = torch.empty_like(R)
        S = torch.zeros(len(t), N + 1, **f64)
        for i in range(N):
            X[:, i] = (R[:, i] - S) / diag[:, i, None]
            S = S + r[i] * X[:, i]
        A_out[start : start + len(t)] = Td[:, None] * X[:, :, :N] / Td[None, :]
        B_out[start : start + len(t)] = Td * X[:, :, N]
    Tn = np.sqrt(2 * np.arange(N, dtype=np.float64) + 1)
    E = (Tn[:, None] * ss.eval_legendre(np.arange(N)[:, None], 2 * np.linspace(0.0, 1.0, max_length) - 1)).T
    return A_out, B_out, torch.as_tensor(E.astype(np.float32), device=device)


def init_leg_s(N: int, max_length: int = 1024, device: str | torch.device | None = None):
    """Scale-invariant LegS: per-step bilinear discretisation A_t (L, N, N),
    B_t (L, N) for t = 1..L, and the reconstruction matrix E (L, N), float32
    tensors on `device` (the CUDA device unless told otherwise).  Cached; do
    not write into the results."""
    return _init_leg_s(N, max_length, resolve_device(device))


def encode_leg_s(f: torch.Tensor, A_stacked: torch.Tensor, B_stacked: torch.Tensor) -> torch.Tensor:
    """f (T, C) -> final coefficients (C, N) by the time-varying recurrence
    c_t = A_t c_{t-1} + B_t f_t, one step after the other."""
    T = f.shape[0]
    c = f.new_zeros(f.shape[1], A_stacked.shape[-1])
    with full_precision():
        for t in range(T):
            c = torch.addmm(f[t, :, None] * B_stacked[t, None, :], c, A_stacked[t].T)
    return c


def encode_leg_s_parallel(f: torch.Tensor, A_stacked: torch.Tensor, B_stacked: torch.Tensor,
                          block: int = 64) -> torch.Tensor:
    """Final LegS coefficients (C, N) by a blocked parallel unroll: the T
    steps are split into ceil(T / block) chunks; every chunk's transition
    product ``P_k = A_kM ... A_k1`` and local contribution ``s_k`` are built
    by `block` batched products over all chunks at once, then the chunk
    summaries combine in a short sequential loop.  Exact (no approximation)."""
    T, C = f.shape
    N = A_stacked.shape[-1]
    A = A_stacked[:T]
    b = B_stacked[:T, None, :] * f[:, :, None]  # (T, C, N)
    K = -(-T // block)
    pad = K * block - T
    if pad:  # identity transitions + zero inputs leave the final state unchanged
        A = torch.cat([A, torch.eye(N, dtype=A.dtype, device=A.device).expand(pad, N, N)])
        b = torch.cat([b, b.new_zeros(pad, C, N)])
    A = A.reshape(K, block, N, N)
    b = b.reshape(K, block, C, N)
    P = torch.eye(N, dtype=A.dtype, device=A.device).expand(K, N, N)
    s = b.new_zeros(K, C, N)
    c = f.new_zeros(C, N)
    with full_precision():
        for j in range(block):
            P = A[:, j] @ P
            s = s @ A[:, j].transpose(1, 2) + b[:, j]
        for k in range(K):
            c = c @ P[k].T + s[k]
    return c


def encode_leg_t(f: torch.Tensor, Ad, Bd) -> torch.Tensor:
    A = torch.as_tensor(Ad, dtype=f.dtype, device=f.device)
    B = torch.as_tensor(Bd, dtype=f.dtype, device=f.device)
    c = f.new_zeros(f.shape[1], A.shape[-1])
    with full_precision():
        for t in range(f.shape[0]):
            c = torch.addmm(f[t, :, None] * B[None, :], c, A.T)
    return c


class HiPPOTimeseries(nn.Module):
    """Envelope timeseries parameterized by HiPPO coefficients.

    The parameter is ``c`` (C, N); ``A``, ``B`` and ``E`` are buffers (not part
    of the state dict).  ``init_params(f (T, C))`` sets ``c`` to the encoding
    of `f` and returns ``{"c": c}``; ``decode(params)`` -> (T, C) (of ``c``
    itself when no params are given).  The envelopes are zero padded by
    `padding` frames on both sides before encoding and trimmed after decoding.
    """

    def __init__(self, T: int, n_envelopes: int, N: int = 512, invariance: str = "s",
                 padding: int = 128, device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.padding = padding
        self.T_pad = T + 2 * padding
        self.n_envelopes = n_envelopes
        self.invariance = invariance
        if invariance == "s":
            A, B, E = init_leg_s(N, max_length=self.T_pad, device=device)
        else:
            A, B, E = (torch.as_tensor(a, device=device) for a in init_leg_t(N, dt=1.0 / self.T_pad))
        self._set_matrices(A, B, E)
        self.c = nn.Parameter(torch.zeros(n_envelopes, N, device=device))

    def _set_matrices(self, A, B, E):
        for name, value in (("A", A), ("B", B), ("E", E)):
            self.register_buffer(name, value, persistent=False)

    @classmethod
    def from_reference_state(cls, params: dict, A, B, E, padding: int = 128, invariance: str = "s",
                             device: str | torch.device | None = None) -> "HiPPOTimeseries":
        """The module of a reference ``HiPPOTimeseries``: its ``{"c": (C, N)}``
        parameters and its ``A``, ``B``, ``E`` matrices as numpy arrays."""
        device = resolve_device(device)
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        def tensor(a):
            return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

        E, c = tensor(E), tensor(params["c"])
        self.padding, self.T_pad, self.invariance = padding, E.shape[0], invariance
        self.n_envelopes = c.shape[0]
        self._set_matrices(tensor(A), tensor(B), E)
        self.c = nn.Parameter(c)
        return self

    @torch.no_grad()
    def init_params(self, f: torch.Tensor) -> dict:
        fp = F.pad(f.to(self.c), (0, 0, self.padding, self.padding))
        if self.invariance != "s":
            c = encode_leg_t(fp, self.A, self.B)
        else:
            # long tracks at small N: the blocked parallel unroll; its
            # O(T N^3) chunk products overtake the saved latency as N grows
            use_par = fp.shape[0] > 2048 and self.A.shape[-1] <= 64
            c = (encode_leg_s_parallel if use_par else encode_leg_s)(fp, self.A, self.B)
        self.c.copy_(c)
        return {"c": self.c}

    def decode(self, params: dict | None = None) -> torch.Tensor:
        c = self.c if params is None else params["c"]
        with full_precision():
            out = self.E @ c.T
        return out[self.padding : -self.padding]
