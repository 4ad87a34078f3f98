"""Distances between feature distributions.

Counterpart of ``ssar_tpu/metrics/ood.py:83-91`` (``frechet_distance``); the
rest of that module (KID, PRDC, the feature extractors) is not ported yet.
The math runs on the host in float64, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg


def frechet_distance(feats_a, feats_b) -> float:
    """Frechet (FID) distance between two feature sets (N, D): the squared
    distance of the means plus tr(S1 + S2 - 2 sqrtm(S1 S2))."""
    feats_a, feats_b = np.asarray(feats_a, np.float64), np.asarray(feats_b, np.float64)
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.sum((mu1 - mu2) ** 2) + np.trace(s1 + s2 - 2 * covmean))
