"""Preliminary audio-video correspondence study.

Counterpart of ``ssar_tpu/metrics/preliminary.py``: does a corpus of music
videos show more audio-video correspondence than a deliberately misaligned
(permuted) pairing of the same clips?  Per corpus group and both pairings,
:func:`preliminary_study` scores
  - summed sliced Gromov-Wasserstein between stacked deep features
    (:func:`compare_av_feats`),
  - mean trace-correlation / Bures-Wasserstein distances between the
    per-clip time-Gram matrices of those features,
  - DTW statistics between audio and video onset envelopes (host numpy),
  - soft-binned mutual information between tempograms.
Plus the time-series "imaging" transforms of the exploratory tail: Gramian
angular fields and joint recurrence plots in closed form, and MiniRocket's
84 fixed kernels as one grouped dilated ``conv1d`` per dilation.

Random draws go through ``generate/keys.py`` in the JAX package's order.
Plain PyTorch on the inputs' device (``preliminary_study`` puts its columns
on `device`, the CUDA device unless given); convolutions and the Gram
products run in full float32 on the card.
"""
from __future__ import annotations

import csv
from itertools import combinations
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quantile import quantile, quantiles
from ..utils.device import full_precision, resolve_device
from .analysis import mutual_information
from .correlation import sgw
from .rhythmic import dtw_distance

__all__ = [
    "standardize", "time_gram", "trace_correlation_distance",
    "bures_distance_batched", "kullback_distance", "condition_distance",
    "pca_svd", "pca_eig", "compare_av_feats", "preliminary_study",
    "gramian_angular_field", "joint_recurrence_plot",
    "minirocket_fit", "minirocket_transform",
]


# ------------------------------------------------------------ primitives --
def _eigh(A: torch.Tensor):
    """``jnp.linalg.eigh``: the eigen-decomposition of the symmetric part."""
    return torch.linalg.eigh((A + A.mT) / 2)


def standardize(x: torch.Tensor, lo: float = 0.05, hi: float = 0.95) -> torch.Tensor:
    """Quantile-clip then min-max normalise."""
    qlo, qhi = quantiles(x, (lo, hi))
    x = torch.clamp(x, qlo, qhi)
    x = x - x.min()
    return x / torch.clamp(x.max(), min=1e-12)


def time_gram(A: torch.Tensor) -> torch.Tensor:
    """(m, t, p) -> per-clip centred time-Gram (m, t, t) (grand-mean centring)."""
    A = A - A.mean(dim=(1, 2), keepdim=True)
    with full_precision():
        return torch.einsum("mtp,msp->mts", A, A)


def trace_correlation_distance(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """1 - <A, B> / (||A|| ||B||), batched over the leading axis."""
    inner = torch.einsum("mij,mij->m", A, B)
    norms = torch.linalg.matrix_norm(A) * torch.linalg.matrix_norm(B)
    return 1.0 - inner / (norms + 1e-12)


def _sqrtm_psd_batched(A: torch.Tensor) -> torch.Tensor:
    w, v = _eigh(A)
    return torch.einsum("mik,mk,mjk->mij", v, torch.sqrt(torch.clamp(w, min=0.0)), v)


def bures_distance_batched(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """2-Wasserstein (Bures) distance between PSD matrices, batched."""
    B12 = _sqrtm_psd_batched(B)
    C = _sqrtm_psd_batched(torch.einsum("mij,mjk,mkl->mil", B12, A, B12))
    tr = torch.diagonal(A + B - 2 * C, dim1=1, dim2=2).sum(-1)
    return torch.sqrt(torch.clamp(tr, min=0.0))


def kullback_distance(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gaussian KL(N(0,A) || N(0,B)) between PSD matrices, batched, with an
    eigh-based inverse and log-determinant."""
    d = A.shape[-1]
    wa, _ = _eigh(A)
    wb, vb = _eigh(B)
    wa, wb = torch.clamp(wa, min=eps), torch.clamp(wb, min=eps)
    Binv = torch.einsum("mik,mk,mjk->mij", vb, 1.0 / wb, vb)
    logdet = torch.log(wb).sum(-1) - torch.log(wa).sum(-1)
    return 0.5 * (torch.einsum("mij,mji->m", Binv, A) - d + logdet)


def condition_distance(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """log condition number of A^{-1/2} B A^{-1/2}: the spread of the
    generalised eigenvalue spectrum."""
    wa, va = _eigh(A)
    invroot = torch.einsum("mik,mk,mjk->mij", va, 1.0 / torch.sqrt(torch.clamp(wa, min=eps)), va)
    star = torch.einsum("mij,mjk,mkl->mil", invroot, B, invroot)
    w = torch.clamp(torch.linalg.eigvalsh((star + star.mT) / 2), min=eps)
    return torch.log(w[:, -1]) - torch.log(w[:, 0])


def pca_svd(X: torch.Tensor, k: int) -> torch.Tensor:
    """(m, t, p) -> (m, t, k): shared principal axes over all clips and frames
    (row-centred SVD)."""
    m, t, p = X.shape
    flat = X.reshape(m * t, p)
    _, _, vt = torch.linalg.svd(flat - flat.mean(dim=1, keepdim=True), full_matrices=False)
    return (flat @ vt[:k].T).reshape(m, t, k)


def pca_eig(X: torch.Tensor, k: int, scale: bool = False) -> torch.Tensor:
    """Eigendecomposition flavour of :func:`pca_svd` (eigh sorts ascending, so
    the first k axes are the smallest-variance ones, as in the reference)."""
    m, t, p = X.shape
    flat = X.reshape(m * t, p)
    c = flat - flat.mean(dim=1, keepdim=True)
    cov = c.T @ c / (m * t - 1)
    if scale:
        cov = torch.diag(torch.rsqrt(torch.diagonal(cov) + 1e-12)) @ cov
    _, vecs = _eigh(cov)
    return (flat @ vecs[:, :k]).reshape(m, t, k)


# ----------------------------------------------------------------- study --
def _as3d(x) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32)
    return x[..., None] if x.ndim == 2 else x


def compare_av_feats(vid_feats: dict, aud_feats: dict, key, misaligned: bool = False) -> dict:
    """Sum of correspondence scores over every (video feature, audio feature)
    pair; each value is stacked per-clip features (m, t, p) or (m, t), on one
    device.  With ``misaligned`` the video clips are permuted per pair (the
    permutation null).  Returns {"sgw", "pca_corr", "pca_wass"} summed over
    pairs.  ``sgw`` compares the two clip point clouds, so it does not see
    the pairing permutation (as in the reference); the Gram-based scores do.
    """
    from ..generate import keys

    sgws, corrs, wasss = [], [], []
    for vf in vid_feats.values():
        for af in aud_feats.values():
            vf3, af3 = _as3d(vf), _as3d(af)
            key, pk, sk = keys.split(key, 3)
            if misaligned:
                vf3 = vf3[keys.permutation(pk, vf3.shape[0]).to(vf3.device)]
            vg, ag = time_gram(vf3), time_gram(af3)
            sgws.append(sgw(vf3.reshape(vf3.shape[0], -1), af3.reshape(af3.shape[0], -1), key=sk))
            corrs.append(trace_correlation_distance(vg, ag).mean())
            wasss.append(bures_distance_batched(vg, ag).mean())
    sums = torch.stack([torch.stack(v).sum() for v in (sgws, corrs, wasss)]).tolist()
    return dict(zip(("sgw", "pca_corr", "pca_wass"), sums))


def preliminary_study(groups: dict, vid_cols, aud_cols, n_samples: int = 100,
                      onset_cols=("video_onsets", "audio_onsets"),
                      tempogram_cols=(("video_tempogram", "audio_tempogram"),
                                      ("video_fourier_tempogram", "audio_fourier_tempogram")),
                      seed: int = 0, out_dir: str | None = None, device: str | torch.device | None = None):
    """Aligned-vs-misaligned correspondence table per corpus group.

    ``groups`` maps group name -> {column -> stacked array (m, t, ...)}.  For
    every group and both pairings: deep-feature pairs (``vid_cols`` x
    ``aud_cols``), chroma / onsets cross pairs when present, DTW statistics
    between onset envelopes, and tempogram mutual information.  Returns
    (aligned_rows, misaligned_rows); writes ``aligned.csv`` /
    ``misaligned.csv`` under ``out_dir``.
    """
    from ..generate import keys

    device = resolve_device(device)
    key = keys.PRNGKey(seed)
    aligned_rows, misaligned_rows = [], []
    for group, cols in groups.items():
        m = len(next(iter(cols.values())))
        key, gk = keys.split(key)
        take = keys.permutation(gk, m).numpy()[:n_samples]
        cols = {c: torch.as_tensor(np.asarray(v)[take], dtype=torch.float32).to(device) for c, v in cols.items()}
        for mis, rows in ((False, aligned_rows), (True, misaligned_rows)):
            key, k1, k2, k3, k4, dk, tk = keys.split(key, 7)
            row = {"group": group}
            vid = {c: cols[c] for c in vid_cols if c in cols}
            aud = {c: cols[c] for c in aud_cols if c in cols}
            for prefix, v, a, kk in (
                ("acav", vid, aud, k1),
                ("chroma", vid, {c: cols[c] for c in ("audio_chroma",) if c in cols}, k2),
                ("aud_ons", vid, {c: cols[c] for c in ("audio_onsets",) if c in cols}, k3),
                ("vid_ons", {c: cols[c] for c in ("video_onsets",) if c in cols}, aud, k4),
            ):
                if not v or not a:
                    continue
                scores = compare_av_feats(v, a, kk, misaligned=mis)
                row.update({f"{prefix}_{s}": val for s, val in scores.items()})
            von, aon = onset_cols
            if von in cols and aon in cols:
                vo = cols[von].cpu().numpy()
                if mis:
                    vo = vo[keys.permutation(dk, len(vo)).numpy()]
                d = [dtw_distance(v, a) for v, a in zip(vo, cols[aon].cpu().numpy())]
                row.update({"dtw_min": float(np.min(d)), "dtw_med": float(np.median(d)),
                            "dtw_mean": float(np.mean(d)), "dtw_max": float(np.max(d))})
            mis_terms = []
            for vt_c, at_c in tempogram_cols:
                if vt_c in cols and at_c in cols:
                    vt = cols[vt_c]
                    if mis:
                        tk, pk = keys.split(tk)
                        vt = vt[keys.permutation(pk, vt.shape[0]).to(device)]
                    mis_terms += [mutual_information(v.reshape(-1), a.reshape(-1)) for v, a in zip(vt, cols[at_c])]
            row["avmi"] = float(torch.stack(mis_terms).sum()) if mis_terms else 0.0
            rows.append(row)
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for name, rows in (("aligned", aligned_rows), ("misaligned", misaligned_rows)):
            if rows:
                with open(out / f"{name}.csv", "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=sorted({k for r in rows for k in r}))
                    w.writeheader()
                    w.writerows(rows)
    return aligned_rows, misaligned_rows


# ------------------------------------------------- time-series featurizers --
def gramian_angular_field(X, method: str = "summation") -> torch.Tensor:
    """Gramian angular field per channel: each series min-max scaled to
    [-1, 1], phi = arccos(x), GASF[i,j] = cos(phi_i + phi_j) (difference:
    sin(phi_i - phi_j)), in closed form.  (m, t, p) or (t, p) -> (..., p, t, t).
    """
    X = torch.as_tensor(X, dtype=torch.float32)
    squeeze = X.ndim == 2
    if squeeze:
        X = X[None]
    x = X.transpose(1, 2)  # (m, p, t)
    mn = x.min(dim=-1, keepdim=True).values
    mx = x.max(dim=-1, keepdim=True).values
    x = torch.where(mx > mn, 2 * (x - mn) / (mx - mn) - 1, torch.zeros_like(x))
    comp = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))  # sin(arccos x)
    if method == "summation":  # cos(a+b) = cos a cos b - sin a sin b
        G = torch.einsum("mpi,mpj->mpij", x, x) - torch.einsum("mpi,mpj->mpij", comp, comp)
    else:  # sin(a-b) = sin a cos b - cos a sin b
        G = torch.einsum("mpi,mpj->mpij", comp, x) - torch.einsum("mpi,mpj->mpij", x, comp)
    return G[0] if squeeze else G


def joint_recurrence_plot(X, percentage: float = 50.0) -> torch.Tensor:
    """Joint recurrence plot: per channel, the pairwise-distance matrix is
    binarised at its ``percentage``-th percentile; the JRP is their product
    across channels.  (m, t, p) or (t, p) -> (..., t, t)."""
    X = torch.as_tensor(X, dtype=torch.float32)
    squeeze = X.ndim == 2
    if squeeze:
        X = X[None]
    x = X.transpose(1, 2)  # (m, p, t)
    d = torch.sqrt((x[..., :, None] - x[..., None, :]) ** 2)  # (m, p, t, t)
    thr = quantile(d.reshape(*d.shape[:2], -1), percentage / 100.0, axis=-1)
    J = torch.prod((d <= thr[..., None, None]).to(torch.float32), dim=1)
    return J[0] if squeeze else J


_MR_KLEN = 9
_MR_INDICES = np.array(list(combinations(range(_MR_KLEN), 3)), np.int64)  # 84 kernels


def _mr_kernels() -> np.ndarray:
    W = -np.ones((len(_MR_INDICES), _MR_KLEN), np.float32)
    for i, idx in enumerate(_MR_INDICES):
        W[i, idx] = 2.0  # weights {-1, 2}, three 2s -> zero-sum kernels
    return W


def _mr_dilations(t: int, n_dilations: int = 8) -> np.ndarray:
    max_exp = np.log2(max((t - 1) / (_MR_KLEN - 1), 1.0))
    d = np.unique(np.floor(2 ** np.linspace(0, max_exp, n_dilations)).astype(np.int64))
    return np.maximum(d, 1)


def minirocket_fit(X, quantiles_per_kernel: int = 4, seed: int = 0) -> dict:
    """Fit MiniRocket's pooling biases on sample data (m, t, p) (Dempster et
    al. 2021): 84 fixed zero-sum kernels of length 9 at a fixed dilation
    ladder; the biases are quantiles of each (kernel, dilation)'s convolution
    output on `X`.  Multivariate inputs are mixed by a fixed random channel
    projection per kernel."""
    X = torch.as_tensor(X, dtype=torch.float32)
    m, t, p = X.shape
    dilations = _mr_dilations(t)
    rng = np.random.RandomState(seed)
    mix = rng.randn(len(_MR_INDICES), p).astype(np.float32) / np.sqrt(p) if p > 1 \
        else np.ones((len(_MR_INDICES), 1), np.float32)
    qs = np.linspace(0.1, 0.9, quantiles_per_kernel).astype(np.float32)
    conv = _mr_conv(X, mix, dilations)  # (m, D, 84, t)
    flat = conv.permute(1, 2, 0, 3).reshape(len(dilations), len(_MR_INDICES), -1)
    biases = quantile(flat, qs, axis=-1)  # (Q, D, 84), from one sort
    return {"dilations": dilations, "mix": mix, "biases": biases.cpu().numpy()}


def _mr_conv(X: torch.Tensor, mix: torch.Tensor, dilations) -> torch.Tensor:
    """(m, t, p) -> (m, n_dilations, 84, t): all 84 kernels at every dilation
    as one grouped dilated conv per dilation, on the channel-mixed series."""
    W = torch.as_tensor(_mr_kernels(), device=X.device)[:, None, :]  # (84, 1, 9)
    mix = torch.tensor(np.asarray(mix), dtype=torch.float32, device=X.device)
    with full_precision():
        mixed = torch.einsum("mtp,kp->mkt", X, mix)  # (m, 84, t)
        outs = [F.conv1d(mixed, W, padding=(_MR_KLEN // 2) * int(d), dilation=int(d), groups=W.shape[0])
                for d in dilations]
    return torch.stack(outs, 1)


def minirocket_transform(X, params: dict) -> torch.Tensor:
    """(m, t, p) -> (m, n_features) PPV features: the fraction of positions
    where each (kernel, dilation) conv exceeds each fitted bias."""
    X = torch.as_tensor(X, dtype=torch.float32)
    conv = _mr_conv(X, params["mix"], params["dilations"])  # (m, D, 84, t)
    biases = torch.tensor(np.asarray(params["biases"]), device=X.device)  # (Q, D, 84)
    ppv = (conv[:, None] > biases[None, :, :, :, None]).to(torch.float32).mean(-1)  # (m, Q, D, 84)
    return ppv.reshape(X.shape[0], -1)
