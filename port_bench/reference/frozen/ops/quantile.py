# Frozen copy of ssar_tpu_torch/ops/quantile.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Exact quantiles and percentile clamps, on the device.

Counterpart of ``ssar_tpu/ops/quantile.py``.  Linear interpolation between
order statistics (``pos = q * (n - 1)``), computed as
``lo * (1 - frac) + hi * frac`` as ``jnp.quantile`` does.  Sort-based, so
there is no device-to-host copy on the feature path and no size limit
(``torch.quantile`` refuses inputs above 2**24 elements).
"""
from __future__ import annotations

import torch


def _interp(sorted_x: torch.Tensor, q, dim: int) -> torch.Tensor:
    """Interpolate the order statistics of `sorted_x` (sorted along `dim`) at
    ``q * (n - 1)``, computed in the data's dtype as jnp.quantile does.  A
    scalar `q` removes `dim`; a sequence puts its values on a leading axis in
    place of it."""
    n = sorted_x.shape[dim]
    qs = torch.as_tensor(q, dtype=sorted_x.dtype, device=sorted_x.device)
    pos = qs.reshape(-1) * (n - 1)
    lo = torch.floor(pos)
    frac = (pos - lo).reshape([-1] + [1] * (sorted_x.ndim - 1))
    lo_i = lo.long().clamp(0, n - 1)
    hi_i = torch.ceil(pos).long().clamp(0, n - 1)
    lines = sorted_x.movedim(dim, 0)
    out = lines[lo_i] * (1 - frac) + lines[hi_i] * frac
    return out[0] if qs.ndim == 0 else out


def quantile(x: torch.Tensor, q, axis: int | None = None, keepdims: bool = False, *,
             dim: int | None = None) -> torch.Tensor:
    """Linear-interpolation quantile, ``jnp.quantile(x, q, axis, keepdims)``:
    over all of `x` or along `axis`; a sequence `q` gives a leading axis of
    its values.  ``dim`` is torch's name for `axis`."""
    axis = dim if axis is None else axis
    lead = torch.as_tensor(q).ndim   # 1 for a sequence q, which takes the first axis of the result
    if axis is None:
        out = _interp(torch.sort(x.reshape(-1)).values, q, 0)
        return out.reshape(out.shape[:lead] + (1,) * x.ndim) if keepdims else out
    axis = axis % x.ndim
    out = _interp(torch.sort(x, dim=axis).values, q, axis)
    return out.unsqueeze(axis + lead) if keepdims else out


def quantiles(x: torch.Tensor, qs) -> tuple[torch.Tensor, ...]:
    """``quantile(x, q)`` over all of `x` for each q of `qs`, from one sort."""
    sorted_x = torch.sort(x.reshape(-1)).values
    return tuple(_interp(sorted_x, q, 0) for q in qs)


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float, dim: int | None = None) -> torch.Tensor:
    """Quantile over the elements of `x` where `mask` is True (over all of them,
    or along `dim`).  Invalid entries sort to the end as +inf and the position
    comes from the valid count; with no valid element the result is +inf."""
    if dim is None:
        x, mask, dim = x.reshape(-1), mask.reshape(-1), 0
    big = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    svals = torch.sort(torch.where(mask, x, big), dim=dim).values
    n_valid = mask.sum(dim=dim, keepdim=True)
    pos = torch.clamp(q * (n_valid.to(x.dtype) - 1.0), min=0.0)
    n = svals.shape[dim]
    lo = torch.floor(pos)
    frac = pos - lo
    lo_v = torch.gather(svals, dim, lo.long().clamp(0, n - 1))
    hi_v = torch.gather(svals, dim, torch.ceil(pos).long().clamp(0, n - 1))
    out = torch.where(n_valid > 0, lo_v * (1 - frac) + hi_v * frac, big)
    return out.squeeze(dim)


def clamp_peaks_percentile(signal: torch.Tensor, percent: float) -> torch.Tensor:
    """Upper-clamp each channel at the `percent`-quantile of its local peaks
    (samples strictly above both neighbours; edges compare with themselves)."""
    squeeze = signal.ndim < 2
    if squeeze:
        signal = signal[:, None]
    prev = torch.cat([signal[:1], signal[:-1]])
    nxt = torch.cat([signal[1:], signal[-1:]])
    peaks = (signal > prev) & (signal > nxt)
    thresh = masked_quantile(signal, peaks, percent / 100.0, dim=0)
    out = torch.minimum(signal, thresh)
    return out[:, 0] if squeeze else out


def clamp_upper_percentile(signal: torch.Tensor, percentile: float) -> torch.Tensor:
    """Clamp each column above its `percentile`."""
    return torch.minimum(signal, quantile(signal, percentile / 100.0, axis=0))


def clamp_lower_percentile(signal: torch.Tensor, percentile: float) -> torch.Tensor:
    return torch.maximum(signal, quantile(signal, percentile / 100.0, axis=0))
