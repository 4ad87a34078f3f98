"""Multivariate correlation zoo: losses and evaluation measures.

Counterpart of ``ssar_tpu/metrics/correlation.py``.  Inputs are (T, Dx) and
(T, Dy) feature matrices over time; every measure is plain differentiable
PyTorch on the inputs' device.  Where the reference's result depends on an
order, the port takes the same one: ranks and sorts are stable (the first of
equal values first, as ``jnp.argsort``), and the nearest neighbour is the
first of equal distances (``argmin``).

The SVD-based measures (``svcca``, ``smi``, ``r3``, ``rG``, ``coxhead``,
``pwcca``) do not depend on the signs that an SVD or a QR gives its
singular vectors.  ``r2`` and ``r4`` do (the reference's own tests say so):
they agree with the reference where both LAPACKs choose the same signs.
"""
from __future__ import annotations

import torch

from ..train.losses import orthogonal_procrustes_distance


# ------------------------------------------------------------ helpers ----
def _center(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=0, keepdim=True)


def soft_rank(x: torch.Tensor, regularization_strength: float = 1.0) -> torch.Tensor:
    """Differentiable ranks along axis 0 from smoothed pairwise comparisons:
    (T,) -> (T,), or each column of (T, D)."""
    d = (x[:, None] - x[None, :]) / regularization_strength
    return 0.5 + torch.sigmoid(d).sum(dim=1)


def hard_rank(x: torch.Tensor) -> torch.Tensor:
    """Ranks 1..T along axis 0 in float32, ties in order of position."""
    order = torch.argsort(x, dim=0, stable=True)
    return torch.argsort(order, dim=0, stable=True).to(torch.float32) + 1.0


# ----------------------------------------------------- simple bivariate --
def pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute pearson correlation over all column pairs."""
    x, y = _center(x), _center(y)
    x = x / (torch.linalg.vector_norm(x, dim=0, keepdim=True) + 1e-8)
    y = y / (torch.linalg.vector_norm(y, dim=0, keepdim=True) + 1e-8)
    return (x.T @ y).abs().mean()


def spearman(x: torch.Tensor, y: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """``pearson`` of the columns' ranks (soft ranks when `differentiable`)."""
    rank = soft_rank if differentiable else hard_rank
    return pearson(rank(x), rank(y))


def concordance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Lin's concordance correlation, mean absolute over column pairs."""
    xm, ym = x.mean(dim=0), y.mean(dim=0)
    xv, yv = x.var(dim=0, correction=0), y.var(dim=0, correction=0)
    cov = ((x - xm).T @ (y - ym)) / x.shape[0]
    ccc = 2 * cov / (xv[:, None] + yv[None, :] + (xm[:, None] - ym[None, :]) ** 2 + 1e-8)
    return ccc.abs().mean()


# ------------------------------------------------------- matrix methods --
def _cross(x, y):
    return _center(x).T @ _center(y)


def rv(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Escoufier's RV coefficient."""
    xx, yy, xy = _cross(x, x), _cross(y, y), _cross(x, y)
    return (xy * xy).sum() / (torch.sqrt((xx * xx).sum() * (yy * yy).sum()) + 1e-12)


def rv2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Modified RV2: time-domain Gram matrices without their diagonals, in [-1, 1]."""
    xc, yc = _center(x), _center(y)
    xx = xc @ xc.T
    yy = yc @ yc.T
    xx = xx - torch.diag(torch.diag(xx))
    yy = yy - torch.diag(torch.diag(yy))
    num = (xx * yy).sum()
    den = torch.sqrt((xx * xx).sum() * (yy * yy).sum()) + 1e-12
    return num / den


def rv_adjusted(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Adjusted RV on correlation matrices (standard deviations of ddof 0)."""
    def corr(a):
        a = _center(a)
        s = a.std(dim=0, correction=0) + 1e-8
        return (a / s).T @ (a / s) / a.shape[0]

    xx, yy = corr(x), corr(y)
    a = _center(x) / (x.std(dim=0, correction=0) + 1e-8)
    b = _center(y) / (y.std(dim=0, correction=0) + 1e-8)
    xy = a.T @ b / x.shape[0]
    return (xy * xy).sum() / (torch.sqrt((xx * xx).sum() * (yy * yy).sum()) + 1e-12)


def linear_cka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xy = _cross(x, y)
    xx = _cross(x, x)
    yy = _cross(y, y)
    return (xy * xy).sum() / (torch.linalg.matrix_norm(xx) * torch.linalg.matrix_norm(yy) + 1e-12)


def svcca(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean canonical correlation of the whitened (rank-truncated) inputs."""
    def whiten(a):
        u, s, _ = torch.linalg.svd(_center(a), full_matrices=False)
        return u * (s > eps * s.max())

    qx, qy = whiten(x), whiten(y)
    return torch.linalg.svdvals(qx.T @ qy).mean()


def smi(x: torch.Tensor, y: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Similarity of Matrices Index (orthogonal projection variant)."""
    def basis(a, k_):
        return torch.linalg.svd(_center(a), full_matrices=False)[0][:, :k_]

    kx = k or min(x.shape[1], x.shape[0] - 1)
    ky = k or min(y.shape[1], y.shape[0] - 1)
    s = torch.linalg.svdvals(basis(x, kx).T @ basis(y, ky))
    return (s**2).sum() / min(kx, ky)


def procrustes(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Similarity form: 1 - procrustes distance."""
    return 1.0 - orthogonal_procrustes_distance(x, y)


def autocorrcorr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Correlation of the row-normalised time-Gram matrices over their
    strict upper triangles."""
    def gram(a):
        a = _center(a)
        a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-12)
        return a @ a.T

    T = x.shape[0]
    iu = torch.triu_indices(T, T, offset=1, device=x.device)
    gx = gram(x)[iu[0], iu[1]]
    gy = gram(y)[iu[0], iu[1]]
    gx = gx - gx.mean()
    gy = gy - gy.mean()
    return (gx * gy).sum() / (torch.linalg.vector_norm(gx) * torch.linalg.vector_norm(gy) + 1e-12)


# ----------------------------------- r-family / coxhead / pwcca ----------
def r1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner-product correlation of the time-Gram matrices."""
    xc, yc = _center(x), _center(y)
    num = torch.trace(xc @ yc.T)
    den = torch.sqrt(torch.trace(xc @ xc.T) * torch.trace(yc @ yc.T))
    return num / (den + 1e-12)


def r2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``r1`` on the scaled left singular bases U diag(s) (sign-dependent)."""
    def us(a):
        u, s, _ = torch.linalg.svd(_center(a), full_matrices=False)
        return u * s[None, :]

    return r1(us(x), us(y))


def r3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``r1`` on the orthogonal polar factors U V^T."""
    def uv(a):
        u, _, vt = torch.linalg.svd(_center(a), full_matrices=False)
        return u @ vt

    return r1(uv(x), uv(y))


def r4(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``r1`` on the left singular bases alone (sign-dependent)."""
    def ubasis(a):
        return torch.linalg.svd(_center(a), full_matrices=False)[0]

    return r1(ubasis(x), ubasis(y))


def rG(x: torch.Tensor, y: torch.Tensor, n_components: int | None = None) -> torch.Tensor:
    """``r1`` between the U_k^T U_k Grams; `n_components` defaults to the
    column rank bound min(D, T - 1)."""
    def ubasis(a, k):
        return torch.linalg.svd(_center(a), full_matrices=False)[0][:, :k]

    kx = n_components or min(x.shape[1], x.shape[0] - 1)
    ky = n_components or min(y.shape[1], y.shape[0] - 1)
    ux, uy = ubasis(x, kx), ubasis(y, ky)
    return r1(ux.T @ ux, uy.T @ uy)


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.pinv``: singular values at or below 10 max(m, n) eps times
    the largest are dropped (``torch.linalg.pinv`` keeps down to max(m, n) eps)."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cutoff = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps * s[..., :1]
    s = torch.where(s > cutoff, s, torch.full_like(s, float("inf")))
    return vh.mT @ (u.mT / s[..., None])


def coxhead(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Coxhead's multivariate association (the pseudo-inverse trace form)."""
    if y.shape[1] > x.shape[1]:
        x, y = y, x
    xc, yc = _center(x), _center(y)
    rxx = xc @ xc.T
    ryy = yc @ yc.T
    rxy = xc @ yc.T
    ryx = yc @ xc.T
    rxxinv = _pinv(rxx)
    rrrrinv = _pinv(ryy - ryx @ rxxinv @ rxy)
    return torch.trace(rrrrinv @ ryx @ rxxinv @ rxy) / (torch.trace(rrrrinv @ ryy) + 1e-12)


def pwcca(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Projection-weighted CCA similarity: canonical correlations weighted by
    how much of x projects onto each canonical direction."""
    xc, yc = _center(x), _center(y)
    qx = torch.linalg.qr(xc)[0]
    qy = torch.linalg.qr(yc)[0]
    u, s, _ = torch.linalg.svd(qx.T @ qy, full_matrices=False)
    xdirs = qx @ u
    alpha = (xdirs.T @ xc).abs().sum(dim=1)
    alpha = alpha / (alpha.sum() + 1e-12)
    return (alpha * s).sum()


# --------------------------------------------------------- chatterjee xi --
def xi(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Chatterjee's rank correlation of two 1-D series (ties of x in order of
    position; not differentiable)."""
    x = x.reshape(-1)
    y = y.reshape(-1)
    n = x.shape[0]
    y_ord = y[torch.argsort(x, stable=True)]
    r = (y_ord[:, None] >= y_ord[None, :]).sum(dim=0).to(torch.float32)
    l = (y_ord[:, None] <= y_ord[None, :]).sum(dim=0).to(torch.float32)
    num = n * (r[1:] - r[:-1]).abs().sum()
    den = 2 * (l * (n - l)).sum()
    return 1.0 - num / (den + 1e-12)


def foci_codependence(y: torch.Tensor, x: torch.Tensor, n_neighbors: int = 1) -> torch.Tensor:
    """Azadkia and Chatterjee's unconditional dependence coefficient T(Y, X)
    (CODEC, the statistic behind FOCI's ordering): x (T, d), y (T,).  Each
    row's nearest neighbour is the first of equal euclidean distances."""
    T = y.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(dim=-1)
    d2 = d2 + torch.eye(T, dtype=d2.dtype, device=d2.device) * 1e18
    nn = torch.argmin(d2, dim=1)
    R = (y[:, None] >= y[None, :]).sum(dim=1).to(torch.float32)
    L = (y[:, None] <= y[None, :]).sum(dim=1).to(torch.float32)
    num = (torch.minimum(R, R[nn]) - L**2 / T).sum()
    den = (L * (T - L) / T).sum()
    return num / (den + 1e-12)


# ------------------------------------------- sliced gromov-wasserstein ---
def sgw(x: torch.Tensor, y: torch.Tensor, key=None, n_proj: int = 200) -> torch.Tensor:
    """Sliced Gromov-Wasserstein discrepancy: random unit 1-D projections
    (drawn through ``generate/keys.py`` from `key`, ``PRNGKey(0)`` by
    default, on the inputs' device), sorted matching, 1-D Gromov cost."""
    from ..generate import keys

    if key is None:
        key = keys.PRNGKey(0)
    kx, ky = keys.split(key)
    px = keys.normal(kx, (x.shape[1], n_proj), device=x.device)
    py = keys.normal(ky, (y.shape[1], n_proj), device=y.device)
    px = px / (torch.linalg.vector_norm(px, dim=0, keepdim=True) + 1e-12)
    py = py / (torch.linalg.vector_norm(py, dim=0, keepdim=True) + 1e-12)
    xs = torch.sort(x @ px, dim=0).values
    ys = torch.sort(y @ py, dim=0).values
    da = (xs[:, None, :] - xs[None, :, :]) ** 2
    db = (ys[:, None, :] - ys[None, :, :]) ** 2
    return ((da - db) ** 2).mean(dim=(0, 1)).mean()


CORRELATION_FNS = {
    "pearson": pearson,
    "spearman": spearman,
    "concordance": concordance,
    "autocorrcorr": autocorrcorr,
    "rv": rv,
    "rv2": rv2,
    "rv_adj": rv_adjusted,
    "cka": linear_cka,
    "svcca": svcca,
    "pwcca": pwcca,
    "smi": smi,
    "procrustes": procrustes,
}

# The r-family compares (T, D) matrices by trace inner products, defined only
# for equal column counts.
CORRELATION_FNS_EQUAL_WIDTH = {
    "coxhead": coxhead,
    "r1": r1,
    "r2": r2,
    "r3": r3,
    "r4": r4,
    "rG": rG,
}
