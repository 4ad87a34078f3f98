"""Exploratory analysis toolkit: covariance distances, kNN KL, mutual information.

Counterpart of ``ssar_tpu/metrics/analysis.py``: distances between SPD
covariance matrices, the k-nearest-neighbour KL divergence estimate, a
differentiable mutual-information estimate from soft histograms, and PCA.
Plain PyTorch on the inputs' device (the eigendecompositions are
feature-sized).
"""
from __future__ import annotations

import numpy as np
import torch


def _eye(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[0], dtype=A.dtype, device=A.device)


def covariance(x: torch.Tensor) -> torch.Tensor:
    x = x - x.mean(dim=0)
    return x.T @ x / (x.shape[0] - 1)


def _eigh(A: torch.Tensor):
    """``jnp.linalg.eigh``: the eigen-decomposition of the symmetric part."""
    return torch.linalg.eigh((A + A.mT) / 2)


def _sqrtm_psd(A: torch.Tensor) -> torch.Tensor:
    w, v = _eigh(A)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T


def _logm_psd(A: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    w, v = _eigh(A)
    return (v * torch.log(torch.clamp(w, min=eps))) @ v.T


def frobenius_distance(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(A - B)


def affine_invariant_distance(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Riemannian SPD distance ||log(A^-1/2 B A^-1/2)||_F."""
    A = A + eps * _eye(A)
    B = B + eps * _eye(B)
    w, v = _eigh(A)
    inv_sqrt = (v * (1.0 / torch.sqrt(torch.clamp(w, min=eps)))) @ v.T
    return torch.linalg.matrix_norm(_logm_psd(inv_sqrt @ B @ inv_sqrt))


def log_euclidean_distance(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.linalg.matrix_norm(_logm_psd(A + eps * _eye(A)) - _logm_psd(B + eps * _eye(B)))


def bures_wasserstein_distance(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """W2 distance between zero-mean gaussians with covariances A, B."""
    sA = _sqrtm_psd(A)
    cross = _sqrtm_psd(sA @ B @ sA)
    return torch.sqrt(torch.clamp(torch.trace(A) + torch.trace(B) - 2 * torch.trace(cross), min=0.0))


COVARIANCE_DISTANCES = {
    "frobenius": frobenius_distance,
    "affine_invariant": affine_invariant_distance,
    "log_euclidean": log_euclidean_distance,
    "bures_wasserstein": bures_wasserstein_distance,
}


def knn_kl_divergence(x: torch.Tensor, y: torch.Tensor, k: int = 5) -> torch.Tensor:
    """kNN estimator of KL(p_x || p_y) (Perez-Cruz 2008)."""
    n, d = x.shape
    m = y.shape[0]

    def kdist(a, b, exclude_self):
        d2 = ((a[:, None] - b[None]) ** 2).sum(dim=-1)
        if exclude_self:
            d2 = d2 + _eye(d2) * 1e18
        return torch.sqrt(torch.sort(d2, dim=1).values[:, k - 1])

    rho = kdist(x, x, True)
    nu = kdist(x, y, False)
    return d * torch.log(nu / (rho + 1e-12) + 1e-12).mean() + np.log(m / (n - 1.0))


def mutual_information(x: torch.Tensor, y: torch.Tensor, sigma: float = 1.0, bins: int = 16) -> torch.Tensor:
    """Differentiable MI from soft (gaussian-kernel) histograms."""
    def soft_hist(v):
        v = (v - v.min()) / (v.max() - v.min() + 1e-8)
        centers = torch.linspace(0, 1, bins, dtype=v.dtype, device=v.device)
        w = torch.exp(-0.5 * ((v[:, None] - centers[None]) / (sigma / bins)) ** 2)
        return w / (w.sum(dim=1, keepdim=True) + 1e-12)

    px = soft_hist(x.reshape(-1))
    py = soft_hist(y.reshape(-1))
    pxy = px.T @ py / px.shape[0]
    pxm = pxy.sum(dim=1, keepdim=True)
    pym = pxy.sum(dim=0, keepdim=True)
    return (pxy * torch.log((pxy + 1e-12) / (pxm @ pym + 1e-12))).sum()


def pca(x: torch.Tensor, n_components: int):
    """(T, D) -> (components (n, D), explained variance, projected (T, n))."""
    xc = x - x.mean(dim=0)
    _, s, vt = torch.linalg.svd(xc, full_matrices=False)
    var = s**2 / (x.shape[0] - 1)
    return vt[:n_components], var[:n_components], xc @ vt[:n_components].T
