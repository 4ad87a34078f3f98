# Frozen copy of ssar_tpu_torch/ops/dct.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""DCT-II along the last axis via one FFT (the MFCC front end).

Counterpart of ``ssar_tpu/ops/dct.py``: the even/odd permutation makes one
complex FFT of length N give the length-N DCT-II.
"""
from __future__ import annotations

import numpy as np
import torch


def dct(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """Type-II DCT over the last axis; `norm` in {None, "ortho"}."""
    in_shape = x.shape
    N = in_shape[-1]
    x = x.reshape(-1, N)

    v = torch.cat([x[:, ::2], x[:, 1::2].flip(1)], dim=1)
    Vc = torch.fft.fft(v, dim=1)

    k = -torch.arange(N, dtype=x.dtype, device=x.device)[None, :] * np.pi / (2 * N)
    V = Vc.real * torch.cos(k) - Vc.imag * torch.sin(k)

    if norm == "ortho":
        V = torch.cat([V[:, :1] / (np.sqrt(N) * 2), V[:, 1:] / (np.sqrt(N / 2) * 2)], dim=1)
    return (2 * V).reshape(in_shape)
