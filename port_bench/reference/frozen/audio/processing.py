# Frozen copy of ssar_tpu_torch/audio/processing.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Signal-processing helpers: normalisation and emphasis, plus the op re-exports.

Counterpart of ``ssar_tpu/audio/processing.py``: the op re-exports, min-max
``normalize``, the IQR ``standardize``, the spectral flux and onset envelope
that the video onsets use, ``emphasize`` and the beat-synchronising
``sync_agg``.  Quantiles are the port's sort-based ones (``ops/quantile.py``),
which take any number of elements.
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
    quantiles,
)


def normalize(array: torch.Tensor) -> torch.Tensor:
    """Min-max to [0, 1]."""
    array = array - array.min()
    return array / (array.max() + 1e-8)


def standardize(array: torch.Tensor) -> torch.Tensor:
    """Clamp to [first quartile, third quartile + 1e-10], then min-max."""
    lo, hi = quantiles(array, (0.25, 0.75))
    return normalize(torch.minimum(torch.maximum(array, lo), hi + 1e-10))


def spectral_flux(spec: torch.Tensor) -> torch.Tensor:
    """Forward time difference of a (T, F) spectrum; the last row is 0 - spec[T-1]."""
    return torch.diff(spec, dim=0, append=spec.new_zeros(1, spec.shape[1]))


def onset_envelope(flux: torch.Tensor) -> torch.Tensor:
    """Half-wave-rectified flux summed over (T, F)'s F, clamped to its 2.5 and
    97.5 percentiles, then scaled to [0, 1] (a constant envelope gives NaN, as
    in the reference)."""
    u = (0.5 * (flux + flux.abs())).sum(dim=1)
    lo, hi = quantiles(u, (0.025, 0.975))
    u = torch.minimum(torch.maximum(u, lo), hi)
    u = u - u.min()
    return u / u.max()


def emphasize(envs: torch.Tensor, strength: float, percentile: float) -> torch.Tensor:
    """tanh expander above the per-column percentile."""
    mn = envs.amin(dim=0)
    x = envs - mn
    mx = x.amax(dim=0)
    x = x / mx
    x = x * (1 + torch.tanh(strength * (x - quantile(x, percentile / 100.0, axis=0))))
    return (x * mx) + mn


def sync_agg(data: torch.Tensor, slices: list, aggregate=torch.mean, axis: int = -1,
             pad_slice: bool = False) -> torch.Tensor:
    """Aggregate `data` over a host list of index slices along `axis` (an int
    is a one-wide slice); `aggregate` is called as ``aggregate(x, dim=axis)``
    and must return a tensor.  With `pad_slice` the last index is added as a
    slice of its own."""
    if pad_slice:
        slices = list(slices) + [data.shape[axis] - 1]
    idx = [slice(None)] * data.ndim
    outs = []
    for segment in slices:
        if isinstance(segment, int):
            segment = slice(segment, segment + 1)
        idx[axis] = segment
        outs.append(aggregate(data[tuple(idx)], dim=axis))
    return torch.stack(outs, dim=axis)
