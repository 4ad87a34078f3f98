"""Signal-processing helpers: normalisation and emphasis, plus the op re-exports.

Counterpart of ``ssar_tpu/audio/processing.py`` (the re-exports of its lines
10-18; ``standardize``, ``spectral_flux``, ``onset_envelope`` and
``sync_agg`` come with the reactivity metrics).
"""
from __future__ import annotations

import torch

from ..ops.gaussian import gaussian_filter  # noqa: F401
from ..ops.iir import high_pass, low_pass, mid_pass  # noqa: F401
from ..ops.median import median_filter  # noqa: F401
from ..ops.quantile import (  # noqa: F401
    clamp_lower_percentile,
    clamp_peaks_percentile,
    clamp_upper_percentile,
    quantile,
)


def normalize(array: torch.Tensor) -> torch.Tensor:
    """Min-max to [0, 1]."""
    array = array - array.min()
    return array / (array.max() + 1e-8)


def emphasize(envs: torch.Tensor, strength: float, percentile: float) -> torch.Tensor:
    """tanh expander above the per-column percentile."""
    mn = envs.amin(dim=0)
    x = envs - mn
    mx = x.amax(dim=0)
    x = x / mx
    x = x * (1 + torch.tanh(strength * (x - quantile(x, percentile / 100.0, dim=0))))
    return (x * mx) + mn
