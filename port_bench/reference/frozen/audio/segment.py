# Frozen copy of ssar_tpu_torch/audio/segment.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Differentiable Laplacian music-structure segmentation.

Counterpart of ``ssar_tpu/audio/segment.py``: beat-synchronous envelope ->
k-NN recurrence matrix with gaussian affinity -> time-lag median filter ->
balanced combination with the path (sequence) graph -> normalised-Laplacian
eigenvectors -> differentiable soft k-means for k in {2, 4, 6, 8, 12, 16}.

``laplacian_segmentation`` runs on its input's device and is differentiable:
both of its median filters (7 taps on the sheared (2n, n) lag matrix, 9 taps
on the (n, n) eigenvectors) go through ``ops/median.py``, i.e. through the
sliding-median kernels, forward and backward, on a CUDA tensor.  Beats come
from the host tracker as a python list.  ``laplacian_segmentation_np`` is the
same algorithm in numpy float64 on the host, for one-off per-clip calls.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.median import median_filter
from .beat import _median_lower_upper


def distance_matrix(x: torch.Tensor, p: float = 2.0) -> torch.Tensor:
    d = ((x[:, None, :] - x[None, :, :]).abs() ** p).sum(dim=2) + 1e-8
    return d ** (1.0 / p)


def recurrence_matrix(data: torch.Tensor, k: int | None = None, width: int = 1,
                      sym: bool = False, bandwidth: float | None = None) -> torch.Tensor:
    """k-NN gaussian affinity recurrence matrix."""
    t = data.shape[0]
    data = data.reshape(t, -1)
    if k is None:
        k = 2 * int(np.ceil(np.sqrt(t - 2 * width + 1))) if t > 2 * width + 1 else 2
    k = int(min(k, t - 1))

    rec = distance_matrix(data)
    # exclude a diagonal band of +-(width - 1)
    idx = torch.arange(t, device=data.device)
    band = (idx[:, None] - idx[None, :]).abs() < width
    rec = torch.where(band, torch.zeros_like(rec), rec)
    rec = rec + (rec == 0) * 1e20

    # keep only the k smallest links per column
    neg_vals, top_idx = torch.topk(-rec.T, k, dim=1)
    rec = torch.zeros_like(rec).scatter(1, top_idx, -neg_vals).T

    if sym:
        rec = torch.minimum(rec, rec.T)
    if bandwidth is None:
        bandwidth = _median_lower_upper(rec.amax(dim=1), dim=0)

    rec = rec * (rec >= 0)
    rec = torch.exp(rec / (-1.0 * bandwidth - 1e-12))  # eps: all-equal rows
    return rec * (rec < 1)  # zero out the 1e20 placeholders and self-links


def shear(X: torch.Tensor, factor: int) -> torch.Tensor:
    """Column i rolled by factor * i (one gather)."""
    n, m = X.shape
    rows = (torch.arange(n, device=X.device)[:, None] - factor * torch.arange(m, device=X.device)[None, :]) % n
    return X.gather(0, rows)


def timelag_median_filter(rec: torch.Tensor) -> torch.Tensor:
    """Median filter along diagonals: shear -> horizontal filter -> unshear."""
    t = rec.shape[0]
    lag = shear(F.pad(rec, (0, 0, 0, t)), -1)
    lag = median_filter(lag, 7, axis=1, mode="reflect")
    return shear(lag, 1)[:t]


def _kmeans_pp_draws(k: int) -> list[float]:
    return [float(np.random.RandomState(42 + idx).rand()) for idx in range(1, k)]


def _kmeans_pp_init(data: np.ndarray, k: int) -> np.ndarray:
    """k-means++ with the reference's fixed seeds (numpy, host)."""
    centroids = [data[0]]
    for r in _kmeans_pp_draws(k):
        dist_sq = np.array([min(float(np.inner(c - x, c - x)) for c in centroids) for x in data])
        probs = dist_sq / (dist_sq.sum() + 1e-8)
        i = min(int(np.searchsorted(probs.cumsum(), r)), len(data) - 1)
        centroids.append(data[i])
    return np.array(centroids)


def _kmeans_pp_init_torch(data: torch.Tensor, k: int) -> torch.Tensor:
    """The same k-means++ init and fixed draws on the data's device (the draws
    are host constants; the chosen indices stay on the device)."""
    n = data.shape[0]
    centroids = [data[0]]
    min_d = torch.full((n,), float("inf"), dtype=data.dtype, device=data.device)
    for r in _kmeans_pp_draws(k):
        min_d = torch.minimum(min_d, ((data - centroids[-1]) ** 2).sum(dim=1))
        probs = min_d / (min_d.sum() + 1e-8)
        i = torch.searchsorted(probs.cumsum(0), torch.tensor(r, dtype=data.dtype, device=data.device))
        centroids.append(data[i.clamp(0, n - 1)])
    return torch.stack(centroids)


def differentiable_k_means(data: torch.Tensor, k: int, num_iter: int = 100, cluster_temp: float = 5.0):
    """Soft k-means on the unit sphere; returns (centroids, assignments, similarities)."""
    data = data / (torch.linalg.vector_norm(data, dim=1, keepdim=True) + 1e-12)
    mu = _kmeans_pp_init_torch(data.detach(), k)
    for _ in range(num_iter):
        r = torch.softmax(cluster_temp * (data @ mu.T), dim=1)
        mu = (r.T @ data) / (r.sum(dim=0)[:, None] + 1e-12)
    dist = data @ mu.T
    return mu, torch.softmax(cluster_temp * dist, dim=1), dist


def laplacian_segmentation(envelope: torch.Tensor, beats, ks=(2, 4, 6, 8, 12, 16)):
    """Soft one-hot segmentations per k.

    envelope (T, C); beats: host list of frame indices.  Returns a list of
    (T, k) soft assignments on the envelope's device.
    """
    T = envelope.shape[0]
    bounds = [0] + [int(b) for b in beats] + [T]
    Csync = torch.stack([
        _median_lower_upper(envelope[b1:b2] if b2 > b1 else envelope[b1:b1 + 1], dim=0)
        for b1, b2 in zip(bounds[:-1], bounds[1:])
    ])

    R = recurrence_matrix(Csync, width=3, sym=True)
    Rf = timelag_median_filter(R)

    path_distance = (torch.diff(Csync, dim=0) ** 2).sum(dim=1)
    sigma = _median_lower_upper(path_distance, dim=0)
    path_sim = torch.exp(-path_distance / (sigma + 1e-12))  # eps: constant envelopes
    R_path = torch.diag(path_sim, 1) + torch.diag(path_sim, -1)

    deg_path = R_path.sum(dim=1)
    deg_rec = Rf.sum(dim=1)
    mu = deg_path.dot(deg_path + deg_rec) / (((deg_path + deg_rec) ** 2).sum() + 1e-12)

    A = mu * Rf + (1 - mu) * R_path
    # symmetric normalised laplacian, dense
    dinv = 1.0 / torch.sqrt(torch.clamp(A.sum(dim=1), min=1e-12))
    L = torch.eye(A.shape[0], dtype=A.dtype, device=A.device) - dinv[:, None] * A * dinv[None, :]
    # the median-filtered recurrence is not symmetric; the reference's eigh
    # takes the symmetric part (LAPACK would read the lower triangle only)
    _, evecs = torch.linalg.eigh((L + L.T) / 2)

    evecs = median_filter(evecs.T, 9, axis=1, mode="reflect").T
    Cnorm = torch.cumsum(evecs**2, dim=1) ** 0.5

    n_sync = Csync.shape[0]
    # nearest-neighbour upsample back to frame rate
    src = torch.clamp((torch.arange(T, device=envelope.device) * n_sync) // T, 0, n_sync - 1)
    segmentations = []
    for k in ks:
        ke = min(k, n_sync)  # short clips: fewer beat-sync frames than segments
        X = evecs[:, :ke] / (Cnorm[:, ke - 1 : ke] + 1e-12)
        _, seg, _ = differentiable_k_means(X, ke)
        if ke < k:  # pad assignment columns so downstream shapes stay (T, k)
            seg = F.pad(seg, (0, k - ke))
        segmentations.append(seg[src])
    return segmentations


def _np_median_filter(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Sliding median along `axis`, np.pad 'reflect' semantics (odd k)."""
    p = k // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (p, p)
    xp = np.pad(x, pad, mode="reflect")
    windows = np.stack([np.take(xp, np.arange(i, i + x.shape[axis]), axis=axis)
                        for i in range(k)], axis=-1)
    return np.median(windows, axis=-1)


def laplacian_segmentation_np(envelope: np.ndarray, beats, ks=(2, 4, 6, 8, 12, 16)):
    """Numpy float64 host implementation of :func:`laplacian_segmentation`:
    same algorithm, same fixed k-means++ draws, except that ``np.linalg.eigh``
    reads the Laplacian's lower triangle where the differentiable version
    takes its symmetric part (as the reference's two versions do), so the two
    agree in most labels, not in values.  For one-off per-clip calls with a
    clip-specific beat count, where matrices have tens of rows."""
    envelope = np.asarray(envelope, np.float64)
    T = envelope.shape[0]
    bounds = [0] + [int(b) for b in beats] + [T]
    Csync = np.stack([
        np.median(envelope[b1:b2] if b2 > b1 else envelope[b1:b1 + 1], axis=0)
        for b1, b2 in zip(bounds[:-1], bounds[1:])
    ])

    t = Csync.shape[0]
    data = Csync.reshape(t, -1)
    width = 3
    k_nn = 2 * int(np.ceil(np.sqrt(t - 2 * width + 1))) if t > 2 * width + 1 else 2
    k_nn = int(min(k_nn, t - 1))

    d = np.abs(data[:, None, :] - data[None, :, :]) ** 2.0
    rec = (d.sum(axis=2) + 1e-8) ** 0.5
    idx = np.arange(t)
    band = np.abs(idx[:, None] - idx[None, :]) < width
    rec[band] = 0.0
    rec = rec + (rec == 0) * 1e20
    # keep only the k smallest links per column
    keep = np.zeros_like(rec)
    order = np.argsort(rec.T, axis=1)[:, :k_nn]
    keep.T[np.arange(t)[:, None], order] = rec.T[np.arange(t)[:, None], order]
    rec = keep
    rec = np.minimum(rec, rec.T)  # sym=True
    bandwidth = np.median(np.max(rec, axis=1))
    rec = rec * (rec >= 0)
    rec = np.exp(rec / (-1.0 * bandwidth - 1e-12))
    rec = rec * (rec < 1)

    # time-lag median filter via shear -> horizontal median -> unshear
    rec_p = np.pad(rec, ((0, t), (0, 0)))
    lag = np.stack([np.roll(rec_p[:, i], -i) for i in range(rec_p.shape[1])], axis=1)
    lag = _np_median_filter(lag, 7, axis=1)
    Rf = np.stack([np.roll(lag[:, i], i) for i in range(lag.shape[1])], axis=1)[:t]

    path_distance = np.sum(np.diff(Csync, axis=0) ** 2, axis=1)
    sigma = np.median(path_distance)
    path_sim = np.exp(-path_distance / (sigma + 1e-12))
    R_path = np.diag(path_sim, k=1) + np.diag(path_sim, k=-1)

    deg_path = R_path.sum(axis=1)
    deg_rec = Rf.sum(axis=1)
    mu = deg_path.dot(deg_path + deg_rec) / (np.sum((deg_path + deg_rec) ** 2) + 1e-12)
    A = mu * Rf + (1 - mu) * R_path
    deg = A.sum(axis=1)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    L = np.eye(t) - dinv[:, None] * A * dinv[None, :]
    _, evecs = np.linalg.eigh(L)

    evecs = _np_median_filter(evecs.T, 9, axis=1).T
    Cnorm = np.cumsum(evecs**2, axis=1) ** 0.5

    def softmax(x, axis):
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        return e / e.sum(axis=axis, keepdims=True)

    segmentations = []
    src = np.clip((np.arange(T) * t) // T, 0, t - 1)
    for k in ks:
        ke = min(k, t)
        X = evecs[:, :ke] / (Cnorm[:, ke - 1 : ke] + 1e-12)
        Xn = X / (np.linalg.norm(X, axis=1, keepdims=True) + 1e-12)
        mu_c = _kmeans_pp_init(Xn, ke)
        for _ in range(100):
            r = softmax(5.0 * (Xn @ mu_c.T), axis=1)
            cluster_r = r.sum(axis=0)
            mu_c = (r.T @ Xn) / (cluster_r[:, None] + 1e-12)
        seg = softmax(5.0 * (Xn @ mu_c.T), axis=1)
        if ke < k:
            seg = np.pad(seg, ((0, 0), (0, k - ke)))
        segmentations.append(seg[src])
    return segmentations


def laplacian_segmentation_rosa(audio, sr: float, out_size: int, ks=(2, 4, 6, 8, 16),
                                device: str | torch.device | None = None) -> np.ndarray:
    """CQT-based segmentation with hard labels: the same recurrence pipeline
    driven by the full constant-Q spectrogram (7 octaves, 36 bins each)
    rather than one feature envelope.  The CQT and the onset envelope run on
    `audio`'s device when it is a tensor, else on `device` (the CUDA device
    by default); the beat-synchronous graph math runs on the host in numpy.
    Returns (out_size, len(ks)) integer labels."""
    from ..utils.device import full_precision, resolve_device
    from .beat import onset_strength
    from .beat_host import beat_track
    from .constantq import cqt
    from .convert import power_to_db

    if not isinstance(audio, torch.Tensor):
        audio = torch.as_tensor(np.asarray(audio), dtype=torch.float32).to(resolve_device(device))
    with torch.no_grad(), full_precision():
        C = cqt(audio, sr=int(sr), hop_length=1024, bins_per_octave=36, n_bins=7 * 36).abs()
        C = power_to_db(C, ref_value=float(C.max()))
        env = onset_strength(audio, int(sr)).cpu().numpy()
    _, beats = beat_track(env, sr=sr, hop_length=1024)
    beats = [int(b) for b in beats if 0 < b < C.shape[1]]

    segs = laplacian_segmentation_np(C.T.cpu().numpy(), beats, ks=ks)
    out = np.stack([np.argmax(s, axis=1) for s in segs], axis=1)
    src = np.clip((np.arange(out_size) * out.shape[0]) // out_size, 0, out.shape[0] - 1)
    return out[src]
