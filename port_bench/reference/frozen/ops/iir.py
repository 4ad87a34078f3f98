# Frozen copy of ssar_tpu_torch/ops/iir.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""IIR biquad filters (RBJ cookbook) as a diagonalised first-order recurrence.

Counterpart of ``ssar_tpu/ops/iir.py`` (torchaudio ``lowpass_biquad`` /
``highpass_biquad`` semantics, zero initial conditions).  The 2nd-order
recurrence is split by partial fractions into one first-order *complex*
recurrence (the companion-matrix form is badly non-normal in float32):

    s[n] = p s[n-1] + x[n],    y[n] = b0 x[n] + 2 Re(A s[n-1]).

The recurrence runs blocked and in parallel: within a block of ``_BLOCK``
samples it is one product with the lower-triangular Toeplitz matrix of pole
powers; the block carries are the same recurrence, one level up, with
multiplier ``p**_BLOCK`` (recursively, so the depth is log_BLOCK(L)).
"""
from __future__ import annotations

import numpy as np
import torch

_BLOCK = 256


def biquad_coeffs(kind: str, sr: float, cutoff: float, Q: float = 0.7071067811865476):
    """RBJ cookbook biquad coefficients, normalised by a0."""
    w0 = 2.0 * np.pi * cutoff / sr
    alpha = np.sin(w0) / (2.0 * Q)
    cosw0 = np.cos(w0)
    if kind == "lowpass":
        b0, b1, b2 = (1 - cosw0) / 2, 1 - cosw0, (1 - cosw0) / 2
    elif kind == "highpass":
        b0, b1, b2 = (1 + cosw0) / 2, -(1 + cosw0), (1 + cosw0) / 2
    else:
        raise ValueError(kind)
    a0, a1, a2 = 1 + alpha, -2 * cosw0, 1 - alpha
    return (b0 / a0, b1 / a0, b2 / a0), (a1 / a0, a2 / a0)


def _pole_powers(p: complex, n: int, cdtype, device) -> torch.Tensor:
    return torch.as_tensor(p ** np.arange(n), dtype=cdtype, device=device)


def linear_recurrence(x: torch.Tensor, p: complex) -> torch.Tensor:
    """s[n] = p s[n-1] + x[n] along the last axis (s[-1] = 0), complex x."""
    L = x.shape[-1]
    if L <= _BLOCK:
        pw = _pole_powers(p, L, x.dtype, x.device)
        idx = torch.arange(L, device=x.device)
        diff = idx[:, None] - idx[None, :]
        M = torch.where(diff >= 0, pw[diff.clamp(min=0)], torch.zeros((), dtype=x.dtype, device=x.device))
        return x @ M.T
    n_blocks = -(-L // _BLOCK)
    xb = torch.nn.functional.pad(x, (0, n_blocks * _BLOCK - L)).reshape(*x.shape[:-1], n_blocks, _BLOCK)
    local = linear_recurrence(xb, p)                              # per-block, zero carry-in
    carry = linear_recurrence(local[..., -1], p**_BLOCK)          # block-end states
    prev = torch.nn.functional.pad(carry[..., :-1], (1, 0))       # carry into each block
    pw = _pole_powers(p, _BLOCK + 1, x.dtype, x.device)[1:]       # p^1 .. p^BLOCK
    s = local + prev[..., None] * pw
    return s.reshape(*x.shape[:-1], n_blocks * _BLOCK)[..., :L]


def biquad_apply(x: torch.Tensor, b: tuple, a: tuple) -> torch.Tensor:
    """Apply one normalised biquad along the last axis of `x` (zero ICs)."""
    b0, b1, b2 = (float(v) for v in b)
    a1, a2 = (float(v) for v in a)
    disc = a1 * a1 - 4 * a2
    if disc >= 0:
        raise ValueError("biquad_apply requires complex poles (Q < 0.5 filters unsupported)")
    p = complex(-a1 / 2, np.sqrt(-disc) / 2)
    c1, c0 = b1 - b0 * a1, b2 - b0 * a2
    A = (c1 * p + c0) / (p - np.conj(p))

    rdtype = torch.promote_types(x.dtype, torch.float32)
    cdtype = torch.complex128 if rdtype == torch.float64 else torch.complex64
    xr = x.to(rdtype)
    s = linear_recurrence(xr.to(cdtype), p)
    s_prev = torch.nn.functional.pad(s[..., :-1], (1, 0))
    return b0 * xr + 2.0 * (A * s_prev).real


def lowpass_biquad(audio: torch.Tensor, sr: float, cutoff: float) -> torch.Tensor:
    return biquad_apply(audio, *biquad_coeffs("lowpass", sr, cutoff))


def highpass_biquad(audio: torch.Tensor, sr: float, cutoff: float) -> torch.Tensor:
    return biquad_apply(audio, *biquad_coeffs("highpass", sr, cutoff))


def low_pass(audio: torch.Tensor, sr: float, fmax: float = 200.0) -> torch.Tensor:
    return lowpass_biquad(audio, sr, fmax)


def high_pass(audio: torch.Tensor, sr: float, fmin: float = 4000.0) -> torch.Tensor:
    return highpass_biquad(audio, sr, fmin)


def mid_pass(audio: torch.Tensor, sr: float, fmin: float = 200.0, fmax: float = 4000.0) -> torch.Tensor:
    """high_pass at fmax, then low_pass at fmin (the reference's order)."""
    return low_pass(high_pass(audio, sr, fmax), sr, fmin)
