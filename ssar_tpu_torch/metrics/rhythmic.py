"""Rhythmic audio-reactivity metric: ``percentile_clip`` only.

Counterpart of ``ssar_tpu/metrics/rhythmic.py:22-39``, which the patch
system's envelopes use.  The rest of that file (the onset and video absdiff
envelopes and ``rhythmic_reactivity``) is queue item A4 of ``ROADMAP.md``.
"""
from __future__ import annotations

import torch

from ..ops.quantile import masked_quantile


def percentile_clip(signal: torch.Tensor, percent: float) -> torch.Tensor:
    """Clamp each channel to [0, the `percent`-quantile of its local peaks]
    (samples strictly above both neighbours; the edges compare with
    themselves), then divide it by its maximum."""
    squeeze = signal.ndim < 2
    if squeeze:
        signal = signal[:, None]
    prev = torch.cat([signal[:1], signal[:-1]])
    nxt = torch.cat([signal[1:], signal[-1:]])
    peaks = (signal > prev) & (signal > nxt)
    thresh = masked_quantile(signal, peaks, percent / 100.0, dim=0)
    out = torch.minimum(torch.clamp(signal, min=0.0), thresh)
    out = out / (out.amax(dim=0) + 1e-12)
    return out[:, 0] if squeeze else out
