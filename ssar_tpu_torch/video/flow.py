"""Optical flow from convolutions: Farneback (plain and certainty-weighted
with parametrised warps) and Lucas-Kanade.

Counterpart of ``ssar_tpu/video/flow.py``.  Farneback expands each frame in
gaussian-weighted quadratic polynomials by separable correlations, then
solves for the displacement a few times per level of an average-pooling
pyramid, from the normal equations averaged over a window.  Everything is
convolutions, gathers and closed-form 2 x 2 (or batched small) solves, plain
PyTorch on the frames' device.  The convolutions run inside
``utils/device.py:full_precision`` (no TF32: the reference pins
``Precision.HIGHEST``), and the upsampled flow is ``ops/resize.py``'s
linear resize (``jax.image.resize``'s bilinear).

``farneback_flow`` keeps its per-pixel fields channel-first, (B, C, H, W),
so that the window sums are one grouped convolution; the values are the
reference's (B, H, W, ...) fields.  The |det| < 1e-6 clamp of its 2 x 2
solve magnifies round-off on flat regions, where two devices may disagree.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.median import reflect_indices
from ..ops.resize import resize
from ..utils.device import full_precision


@lru_cache(maxsize=None)
def _poly_basis(n: int, sigma: float):
    """Gaussian applicability times the quadratic basis {1, x, y, x^2, y^2,
    xy} as six (2n+1)^2 kernels, and the inverse of the basis' Gram matrix
    (host numpy, float32)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    w1d = np.exp(-(x**2) / (2 * sigma**2))
    X, Y = np.meshgrid(x, x, indexing="xy")
    w = np.outer(w1d, w1d)
    basis = np.stack([np.ones_like(X), X, Y, X**2, Y**2, X * Y])
    G = np.einsum("ikl,jkl,kl->ij", basis, basis, w)
    kernels = (w[None] * basis).astype(np.float32)
    return kernels, np.linalg.inv(G).astype(np.float32)


def _conv2same(img: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """img (B, H, W) correlated with each of kernels (K, k, k), zero padded
    to the same size -> (B, K, H, W)."""
    k = kernels.shape[-1]
    w = torch.as_tensor(kernels, dtype=img.dtype, device=img.device)[:, None]
    return F.conv2d(img[:, None], w, padding=k // 2)


def _poly_coefs(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(B, H, W) -> (B, 6, H, W) polynomial coefficients [c, bx, by, axx, ayy, axy]."""
    kernels, Ginv = _poly_basis(n, sigma)
    proj = _conv2same(img, kernels)
    return torch.einsum("ij,bjhw->bihw", torch.as_tensor(Ginv, device=img.device), proj)


def poly_expansion(img: torch.Tensor, n: int = 7, sigma: float = 1.5):
    """img (B, H, W) -> (A (B, H, W, 2, 2), b (B, H, W, 2), c (B, H, W))."""
    with full_precision():
        coefs = _poly_coefs(img, n, sigma)
    c = coefs[:, 0]
    b = torch.stack([coefs[:, 1], coefs[:, 2]], dim=-1)
    A = torch.stack([torch.stack([coefs[:, 3], coefs[:, 5] / 2], dim=-1),
                     torch.stack([coefs[:, 5] / 2, coefs[:, 4]], dim=-1)], dim=-2)
    return A, b, c


def _bilinear_warp(field: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """field (B, C, H, W) sampled at (x + u, y + v), border-clamped; flow (B, 2, H, W)."""
    B, C, H, W = field.shape
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :]
    sx = torch.clamp(xs + flow[:, 0], 0, W - 1)
    sy = torch.clamp(ys + flow[:, 1], 0, H - 1)
    x0 = torch.clamp(torch.floor(sx), 0, W - 2)
    y0 = torch.clamp(torch.floor(sy), 0, H - 2)
    fx, fy = (sx - x0)[:, None], (sy - y0)[:, None]
    base = (y0.long() * W + x0.long()).reshape(B, 1, H * W)
    flat = field.reshape(B, C, H * W)

    def gather(offset):
        return flat.gather(2, (base + offset).expand(B, C, H * W)).reshape(B, C, H, W)

    return ((1 - fx) * (1 - fy) * gather(0) + fx * (1 - fy) * gather(1)
            + (1 - fx) * fy * gather(W) + fx * fy * gather(W + 1))


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    B, H, W = x.shape
    return x[:, : H // 2 * 2, : W // 2 * 2].reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))


def _box_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean (zero padded) of each channel of (B, C, H, W)."""
    B, C, H, W = x.shape
    kern = np.ones((1, k, k), np.float32) / (k * k)
    return _conv2same(x.reshape(B * C, H, W), kern).reshape(B, C, H, W)


def _upsample_flow(flow: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 2, h, w) -> 2 x the bilinear resize to (B, 2, H, W)."""
    B = flow.shape[0]
    return 2.0 * resize(flow.permute(0, 2, 3, 1), (B, H, W, 2), method="bilinear").permute(0, 3, 1, 2)


def farneback_flow(gray: torch.Tensor, levels: int = 3, iterations: int = 3,
                   poly_n: int = 7, poly_sigma: float = 1.5, win: int = 13) -> torch.Tensor:
    """gray (T, H, W) in [0, 1] -> flow (T - 1, 2, H, W), (u, v) in pixels,
    from each frame to the next."""
    with full_precision():
        pyr1, pyr2 = [gray[:-1] * 255.0], [gray[1:] * 255.0]
        for _ in range(levels - 1):
            pyr1.append(_avg_pool2(pyr1[-1]))
            pyr2.append(_avg_pool2(pyr2[-1]))

        flow = None
        for lvl in range(levels - 1, -1, -1):
            c1 = _poly_coefs(pyr1[lvl], poly_n, poly_sigma)
            c2 = _poly_coefs(pyr2[lvl], poly_n, poly_sigma)
            B, H, W = pyr1[lvl].shape
            # A = [[axx, axy / 2], [axy / 2, ayy]] as channels (a00, a01, a10, a11), b = (bx, by)
            a1 = torch.stack([c1[:, 3], c1[:, 5] / 2, c1[:, 5] / 2, c1[:, 4]], dim=1)
            a2 = torch.stack([c2[:, 3], c2[:, 5] / 2, c2[:, 5] / 2, c2[:, 4]], dim=1)
            b1, b2 = c1[:, 1:3], c2[:, 1:3]
            if flow is None:
                flow = gray.new_zeros(B, 2, H, W)
            else:
                flow = _upsample_flow(flow, H, W)

            for _ in range(iterations):
                A = 0.5 * (a1 + _bilinear_warp(a2, flow))
                d = -0.5 * (_bilinear_warp(b2, flow) - b1)
                a00, a01, a10, a11 = A.unbind(dim=1)
                u0, v0 = flow.unbind(dim=1)
                d0 = d[:, 0] + (a00 * u0 + a01 * v0)
                d1 = d[:, 1] + (a10 * u0 + a11 * v0)
                # G = A^T A and h = A^T d, summed over the window
                G = _box_blur(torch.stack([a00 * a00 + a10 * a10, a00 * a01 + a10 * a11,
                                           a01 * a00 + a11 * a10, a01 * a01 + a11 * a11], dim=1), win)
                h = _box_blur(torch.stack([a00 * d0 + a10 * d1, a01 * d0 + a11 * d1], dim=1), win)
                g00, g01, g10, g11 = G.unbind(dim=1)
                det = g00 * g11 - g01 * g10
                det = torch.where(det.abs() < 1e-6, torch.full_like(det, 1e-6), det)
                u = (g11 * h[:, 0] - g01 * h[:, 1]) / det
                v = (-g10 * h[:, 0] + g00 * h[:, 1]) / det
                flow = torch.stack([u, v], dim=1)
    return flow


# ------------------------------------- parametrized (certainty) Farneback --
@lru_cache(maxsize=None)
def _nc_basis(sigma: float):
    """Separable normalized-convolution basis (host): per axis, the gaussian
    applicability a times the six quadratic basis columns, and the raw
    columns, (k, 6) each, for the width and the height axis."""
    n = int(4 * sigma + 1)
    x = np.arange(-n, n + 1, dtype=np.float64)
    a = np.exp(-(x**2) / (2 * sigma**2))
    one = np.ones_like(x)
    bx = np.stack([one, x, one, x**2, one, x], -1)
    by = np.stack([one, one, x, one, x**2, x], -1)
    return (a[:, None] * bx).astype(np.float32), bx.astype(np.float32), \
        (a[:, None] * by).astype(np.float32), by.astype(np.float32)


def _corr_rows(img: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) correlated along H with one kernel (C, k) per channel."""
    C, k = kernels.shape
    return F.conv2d(img, kernels[:, None, :, None], padding=(k // 2, 0), groups=C)


def _corr_cols(img: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    C, k = kernels.shape
    return F.conv2d(img, kernels[:, None, None, :], padding=(0, k // 2), groups=C)


def poly_expansion_certainty(f: torch.Tensor, c: torch.Tensor, sigma: float = 4.0):
    """Certainty-weighted polynomial expansion (normalized convolution): a
    6 x 6 Gram per pixel from separable correlations of the certainty,
    solved in one batched call.  f (B, H, W), c (B, H, W) or (H, W) ->
    (A (B, H, W, 2, 2), b (B, H, W, 2), C0 (B, H, W))."""
    abx, bx, aby, by = _nc_basis(float(sigma))
    dev = f.device
    gx = torch.as_tensor((abx[:, :, None] * bx[:, None, :]).reshape(-1, 36).T.copy(), device=dev)
    gy = torch.as_tensor((aby[:, :, None] * by[:, None, :]).reshape(-1, 36).T.copy(), device=dev)
    B_, H, W = f.shape
    c3 = c if c.ndim == 3 else c[None].expand(B_, H, W)
    with full_precision():
        G = _corr_cols(_corr_rows(c3[:, None].expand(B_, 36, H, W), gy), gx)
        cf = (c * f)[:, None].expand(B_, 6, H, W)
        v = _corr_cols(_corr_rows(cf, torch.as_tensor(aby.T.copy(), device=dev)),
                       torch.as_tensor(abx.T.copy(), device=dev))
        Gm = G.permute(0, 2, 3, 1).reshape(B_, H, W, 6, 6)
        vm = v.permute(0, 2, 3, 1)
        ridge = 1e-6 * Gm.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] * torch.eye(6, device=dev)
        r = torch.linalg.solve(Gm + ridge, vm[..., None])[..., 0]
    A = torch.stack([torch.stack([r[..., 3], r[..., 5] / 2], -1),
                     torch.stack([r[..., 5] / 2, r[..., 4]], -1)], -2)
    b = torch.stack([r[..., 1], r[..., 2]], -1)
    return A, b, r[..., 0]


def _border_certainty(H: int, W: int) -> np.ndarray:
    """Linear 5-pixel confidence ramp at the image border."""
    i = np.arange(H, dtype=np.float32)[:, None]
    j = np.arange(W, dtype=np.float32)[None, :]
    c = np.minimum(np.minimum(i, H - 1 - i), np.minimum(j, W - 1 - j)) / 5.0
    return np.minimum(c, 1.0)


def _warp_model_S(H: int, W: int, model: str) -> np.ndarray | None:
    """Warp parametrisation S (H, W, 2, k), d = S p, displacements as (x, y)."""
    if model == "constant":
        return None
    y, x = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    k = 6 if model == "affine" else 8
    S = np.zeros((H, W, 2, k), np.float32)
    S[..., 0, 0] = 1
    S[..., 0, 1] = x
    S[..., 0, 2] = y
    S[..., 1, 3] = 1
    S[..., 1, 4] = x
    S[..., 1, 5] = y
    if model == "eight_param":
        S[..., 0, 6] = x * x
        S[..., 0, 7] = x * y
        S[..., 1, 6] = x * y
        S[..., 1, 7] = y * y
    return S


def _gauss_sep_blur(x: torch.Tensor, sigma_flow: float) -> torch.Tensor:
    """Unnormalised gaussian window along H and W of (B, H, W, ...)."""
    n = int(4 * sigma_flow + 1)
    t = np.arange(-n, n + 1, dtype=np.float64)
    w = torch.as_tensor(np.exp(-(t**2) / (2 * sigma_flow**2)).astype(np.float32), device=x.device)
    lead, trail = x.shape[0], x.shape[3:]
    flat = x.reshape(lead, x.shape[1], x.shape[2], -1)
    flat = flat.movedim(-1, 1).reshape(-1, 1, x.shape[1], x.shape[2])
    out = _corr_cols(_corr_rows(flat, w[None]), w[None])[:, 0]
    out = out.reshape(lead, -1, x.shape[1], x.shape[2])
    return out.movedim(1, -1).reshape(x.shape[:3] + trail)


def _nearest_gather(field: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """field (B, H, W, ...) at integer pixel indices (B, H, W)."""
    B, H, W = field.shape[:3]
    flat = field.reshape(B, H * W, -1)
    idx = (yi * W + xi).reshape(B, -1, 1).long()
    out = flat.gather(1, idx.expand(B, idx.shape[1], flat.shape[2]))
    return out.reshape(field.shape[:1] + xi.shape[1:] + field.shape[3:])


def farneback_parametrized(gray: torch.Tensor, model: str = "constant", mu: float = 0.0,
                           sigma: float = 4.0, sigma_flow: float = 4.0,
                           n_pyr: int = 1, num_iter: int = 1) -> torch.Tensor:
    """Certainty-weighted Farneback with parametrised warp models: gray (T,
    H, W) in [0, 1] -> flow (T - 1, 2, H, W), (u, v) in pixels.

    model "constant" solves a 2-vector per pixel; "affine" and
    "eight_param" fit d = S p from the per-pixel normal equations S^T A^T A
    S.  mu != 0 regularises the local solve toward the global parametrised
    warp (mu < 0: trace(G_avg) / 2), under every model.  Batched over frame
    pairs."""
    with full_precision():
        return _farneback_parametrized(gray, model, mu, sigma, sigma_flow, n_pyr, num_iter)


def _farneback_parametrized(gray, model, mu, sigma, sigma_flow, n_pyr, num_iter):
    dev = gray.device
    pyr1, pyr2 = [gray[:-1] * 255.0], [gray[1:] * 255.0]
    for _ in range(n_pyr - 1):
        pyr1.append(_avg_pool2(pyr1[-1]))
        pyr2.append(_avg_pool2(pyr2[-1]))

    flow = None
    for lvl in range(n_pyr - 1, -1, -1):
        p1, p2 = pyr1[lvl], pyr2[lvl]
        B, H, W = p1.shape
        cert = torch.as_tensor(_border_certainty(H, W), device=dev)
        if flow is None:
            flow = gray.new_zeros(B, H, W, 2)
        else:
            flow = 2.0 * resize(flow, (B, H, W, 2), method="bilinear")
        A1, b1, _ = poly_expansion_certainty(p1, cert.expand(p1.shape), sigma)
        A2, b2, _ = poly_expansion_certainty(p2, cert.expand(p2.shape), sigma)
        S = _warp_model_S(H, W, model)
        Sj = None if S is None else torch.as_tensor(S, device=dev)
        ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
        eye2 = torch.eye(2, device=dev)

        for _ in range(num_iter):
            # nearest-pixel displacement gather, certainty 0 off the image
            xi = xs[None] + flow[..., 0].to(torch.int32)
            yi = ys[None] + flow[..., 1].to(torch.int32)
            xi_c = torch.clamp(xi, 0, W - 1)
            yi_c = torch.clamp(yi, 0, H - 1)
            on_img = ((xi == xi_c) & (yi == yi_c)).to(gray.dtype)
            c_ = cert[None] * on_img * _nearest_gather(cert[None].expand(B, H, W)[..., None], xi_c, yi_c)[..., 0]

            A = 0.5 * (A1 + _nearest_gather(A2.reshape(B, H, W, 4), xi_c, yi_c).reshape(B, H, W, 2, 2))
            A = A * c_[..., None, None]
            delB = -0.5 * (_nearest_gather(b2, xi_c, yi_c) - b1) + torch.einsum("bhwij,bhwj->bhwi", A, flow)
            delB = delB * c_[..., None]

            AtA = torch.einsum("bhwki,bhwkj->bhwij", A, A)
            Atb = torch.einsum("bhwki,bhwk->bhwi", A, delB)
            if mu == 0.0:
                if Sj is None:
                    G = _gauss_sep_blur(AtA.reshape(B, H, W, 4), sigma_flow).reshape(B, H, W, 2, 2)
                    h = _gauss_sep_blur(Atb, sigma_flow)
                    ridge = 1e-6 * G.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] * eye2
                    flow = torch.linalg.solve(G + ridge, h[..., None])[..., 0]
                else:
                    k = Sj.shape[-1]
                    GS = torch.einsum("hwik,bhwij,hwjl->bhwkl", Sj, AtA, Sj)
                    hS = torch.einsum("hwik,bhwi->bhwk", Sj, Atb)
                    GS = _gauss_sep_blur(GS.reshape(B, H, W, k * k), sigma_flow).reshape(B, H, W, k, k)
                    hS = _gauss_sep_blur(hS, sigma_flow)
                    ridge = 1e-6 * GS.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] * torch.eye(k, device=dev)
                    sol = torch.linalg.solve(GS + ridge, hS[..., None])[..., 0]
                    flow = torch.einsum("hwik,bhwk->bhwi", Sj, sol)
            else:
                if Sj is None:
                    G_avg = AtA.mean(dim=(1, 2))
                    p_avg = torch.linalg.solve(G_avg, Atb.mean(dim=(1, 2))[..., None])[..., 0]
                    d_avg = p_avg[:, None, None].expand(B, H, W, 2)
                else:
                    G_avg = torch.einsum("hwik,bhwij,hwjl->bkl", Sj, AtA, Sj) / (H * W)
                    h_avg = torch.einsum("hwik,bhwi->bk", Sj, Atb) / (H * W)
                    p_avg = torch.linalg.solve(G_avg, h_avg[..., None])[..., 0]
                    d_avg = torch.einsum("hwik,bk->bhwi", Sj, p_avg)
                tr = G_avg.diagonal(dim1=-2, dim2=-1).sum(-1)
                mu_eff = (0.5 * tr if mu < 0 else torch.full_like(tr, mu))[:, None, None]
                G = _gauss_sep_blur(AtA.reshape(B, H, W, 4), sigma_flow).reshape(B, H, W, 2, 2)
                h = _gauss_sep_blur(Atb, sigma_flow)
                Gr = G + mu_eff[..., None, None] * eye2
                flow = torch.linalg.solve(Gr, (h + mu_eff[..., None] * d_avg)[..., None])[..., 0]

    return flow.movedim(-1, 1)


# -------------------------------------------------------- Lucas-Kanade --
@lru_cache(maxsize=None)
def _gauss_kernel_1d(k: int, sigma: float) -> np.ndarray:
    x = np.arange(k, dtype=np.float64) - (k - 1) / 2
    w = np.exp(-(x**2) / (2 * sigma**2))
    return (w / w.sum()).astype(np.float32)


def _gauss_blur2d(img: torch.Tensor, k: int = 5, sigma: float = 3.0) -> torch.Tensor:
    """(H, W) separable gaussian blur, reflect padded to the same size."""
    w = torch.as_tensor(_gauss_kernel_1d(k, sigma), device=img.device)
    p = k // 2
    H, W = img.shape
    x = img.index_select(0, reflect_indices(H, p, img.device))
    x = F.conv2d(x[None, None], w[None, None, :, None])[0, 0]
    x = x.index_select(1, reflect_indices(W, p, img.device))
    return F.conv2d(x[None, None], w[None, None, None, :])[0, 0]


def lucas_kanade(im1: torch.Tensor, im2: torch.Tensor, win: int = 2) -> torch.Tensor:
    """Single-level Lucas-Kanade flow of (H, W) grayscale frames: central
    differences, gaussian-blurred structure tensor, window sums of width
    2 win + 1 from integral images, a closed-form 2 x 2 solve per pixel,
    zero at the borders.  (H, W, 2)."""
    H, W = im1.shape
    with full_precision():
        z = torch.zeros_like(im1)
        I_x, I_y, I_t = z.clone(), z.clone(), z.clone()
        I_x[1:-1, 1:-1] = (im1[1:-1, 2:] - im1[1:-1, :-2]) / 2
        I_y[1:-1, 1:-1] = (im1[2:, 1:-1] - im1[:-2, 1:-1]) / 2
        I_t[1:-1, 1:-1] = im1[1:-1, 1:-1] - im2[1:-1, 1:-1]

        params = torch.stack([_gauss_blur2d(p) for p in
                              (I_x * I_x, I_y * I_y, I_x * I_y, I_x * I_t, I_y * I_t)], dim=-1)
    cum = torch.cumsum(torch.cumsum(params, dim=0), dim=1)
    s = 2 * win + 1
    wp = cum[s:, s:] - cum[s:, :-s] - cum[:-s, s:] + cum[:-s, :-s]

    det = wp[..., 0] * wp[..., 1] - wp[..., 2] ** 2
    nz = det != 0
    safe = torch.where(nz, det, torch.ones_like(det))
    fx = torch.where(nz, (wp[..., 1] * wp[..., 3] - wp[..., 2] * wp[..., 4]) / safe, torch.zeros_like(det))
    fy = torch.where(nz, (wp[..., 0] * wp[..., 4] - wp[..., 2] * wp[..., 3]) / safe, torch.zeros_like(det))

    flow = im1.new_zeros(H, W, 2)
    flow[win + 1 : -1 - win, win + 1 : -1 - win, 0] = fx[:-1, :-1]
    flow[win + 1 : -1 - win, win + 1 : -1 - win, 1] = fy[:-1, :-1]
    return flow


def _pyramid_reduce(img: torch.Tensor) -> torch.Tensor:
    return _gauss_blur2d(img, 5, 1.0)[::2, ::2]


def lucas_kanade_pyramid(im1: torch.Tensor, im2: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Coarse-to-fine Lucas-Kanade over a gaussian pyramid.  (H', W', 2) at
    the first reduced level."""
    pyramid = []
    a, b = im1, im2
    with full_precision():
        for _ in range(levels):
            a, b = _pyramid_reduce(a), _pyramid_reduce(b)
            pyramid.append((a, b))

    flow = lucas_kanade(a, b)
    for p1, p2 in pyramid[-2::-1]:
        up = 2.0 * resize(flow, (flow.shape[0] * 2, flow.shape[1] * 2, 2), method="bilinear")
        flow = up[: p1.shape[0], : p1.shape[1]] + lucas_kanade(p1, p2)
    return flow
