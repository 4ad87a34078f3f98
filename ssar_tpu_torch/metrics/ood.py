"""Image-quality / out-of-distribution metrics: FID, KID, precision, recall,
density and coverage.

Counterpart of ``ssar_tpu/metrics/ood.py``.  The metric math runs on the host
in float64, as the reference's does; the feature extractor is pluggable, any
callable ``(N, H, W, 3) [0, 1] tensor -> (N, D)``:
- ``default_extractor()``: a fixed random-projection + pooling extractor,
  deterministic and distribution-sensitive, usable for relative comparisons
  only (its projection is drawn on the CPU through ``generate/keys.py``, so
  every device uses the same one);
- ``discriminator_extractor(d_params)``: the (B, 512) penultimate features of
  a trained StyleGAN2 discriminator (``gan/discriminator.py``), e.g. the
  calibration run's.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F

from ..utils.device import full_precision, resolve_device


def default_extractor(dim: int = 256, patch: int = 8, seed: int = 0):
    """Deterministic random-feature extractor: patch projections, GELU, then
    mean and max pooling over the patches -> (N, 2 * dim)."""
    from ..generate import keys

    W = keys.normal(keys.PRNGKey(seed), (patch * patch * 3, dim)) / np.sqrt(patch * patch * 3)

    def extract(images: torch.Tensor) -> torch.Tensor:  # (N, H, W, 3) in [0, 1]
        N, H, Wd, C = images.shape
        ph, pw = H // patch, Wd // patch
        x = images[:, : ph * patch, : pw * patch]
        x = x.reshape(N, ph, patch, pw, patch, C).permute(0, 1, 3, 2, 4, 5).reshape(N, ph * pw, patch * patch * C)
        with full_precision():
            feats = F.gelu(torch.einsum("npd,df->npf", x - 0.5, W.to(images.device)), approximate="tanh")
        return torch.cat([feats.mean(1), feats.max(1).values], dim=-1)

    return extract


def discriminator_extractor(d_params, resolution: int = 256, channel_multiplier: int = 1, batch_size: int = 32):
    """Features of a trained StyleGAN2 discriminator: (B, H, W, 3) in [0, 1]
    -> (B, 512) penultimate activations, on the images' device.

    `d_params` is a ``gan.discriminator.Discriminator`` or the JAX package's
    parameter tree (converted here).  The last batch is padded with its last
    image to ``batch_size``, as the reference pads it (the minibatch-stddev
    layer sees whole batches).  FID / KID / PRDC through it are absolute for
    this extractor and stable across runs; they are not comparable with
    published Inception or SwAV numbers.
    """
    from ..gan.discriminator import Discriminator

    if isinstance(d_params, torch.nn.Module):
        D = d_params
    else:
        D = Discriminator(resolution=resolution, channel_multiplier=channel_multiplier).load_flax(d_params)
    D.eval()

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        D.to(images.device)
        out = []
        n = images.shape[0]
        for i in range(0, n, batch_size):
            b = images[i : i + batch_size]
            if b.shape[0] < batch_size:
                b = torch.cat([b, b[-1:].expand(batch_size - b.shape[0], *b.shape[1:])])
            with full_precision():
                out.append(D(b * 2.0 - 1.0, features=True)[: min(batch_size, n - i)])
        return torch.cat(out)

    return extract


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


def kernel_distance(feats_a, feats_b, degree: int = 3, gamma: float | None = None, coef0: float = 1.0) -> float:
    """KID: the unbiased polynomial-kernel MMD^2."""
    feats_a, feats_b = np.asarray(feats_a), np.asarray(feats_b)
    gamma = gamma if gamma is not None else 1.0 / feats_a.shape[1]

    def k(x, y):
        return (gamma * x @ y.T + coef0) ** degree

    m, n = len(feats_a), len(feats_b)
    kxx, kyy, kxy = k(feats_a, feats_a), k(feats_b, feats_b), k(feats_a, feats_b)
    term_x = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    term_y = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    return float(term_x + term_y - 2 * kxy.mean())


def prdc(feats_real, feats_fake, k: int = 5) -> dict:
    """Precision / recall / density / coverage (Naeem et al. 2020)."""
    feats_real, feats_fake = np.asarray(feats_real), np.asarray(feats_fake)

    def pairwise(a, b):
        return np.sqrt(np.maximum((a**2).sum(1)[:, None] + (b**2).sum(1)[None] - 2 * a @ b.T, 0))

    d_rr = pairwise(feats_real, feats_real)
    d_ff = pairwise(feats_fake, feats_fake)
    d_rf = pairwise(feats_real, feats_fake)
    r_radii = np.sort(d_rr, axis=1)[:, k]
    f_radii = np.sort(d_ff, axis=1)[:, k]
    return {"precision": float((d_rf < r_radii[:, None]).any(axis=0).mean()),
            "recall": float((d_rf < f_radii[None, :]).any(axis=1).mean()),
            "density": float((d_rf < r_radii[:, None]).sum(axis=0).mean() / k),
            "coverage": float((d_rf.min(axis=1) < r_radii).mean())}


def _to_nhwc(x, device) -> torch.Tensor:
    x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=torch.float32).to(device)
    if x.ndim == 4 and x.shape[1] == 3 and x.shape[-1] != 3:
        x = x.permute(0, 2, 3, 1)
    return x


def compute(real_images, fake_images, extractor=None, metrics=("frechet", "kernel", "prdc"),
            allow_random_extractor: bool = False, device: str | torch.device | None = None) -> dict:
    """FID ("frechet"), KID ("kernel") and PRDC of two image sets, (N, H, W, 3)
    or (N, 3, H, W) floats in [0, 1], featurised on `device` (the CUDA device
    unless given).

    Without an ``extractor`` the fallback is the random-projection extractor,
    whose numbers compare only with other runs of the same extractor, never
    with published FID / KID: it warns unless ``allow_random_extractor``.
    """
    device = resolve_device(device)
    if extractor is None:
        msg = ("ood.compute called without an extractor: falling back to the random-projection features. "
               "The resulting 'FID'/'KID' are NOT comparable to SwAV/Inception numbers; pass a trained "
               "extractor (e.g. discriminator_extractor) for absolute results, or allow_random_extractor=True "
               "to silence this.")
        if not allow_random_extractor:
            warnings.warn(msg, UserWarning, stacklevel=2)
        extractor = default_extractor()

    def features(images):
        f = extractor(_to_nhwc(images, device))
        return f.cpu().numpy() if torch.is_tensor(f) else np.asarray(f)

    fr, ff = features(real_images), features(fake_images)
    out = {}
    if "frechet" in metrics:
        out["frechet"] = frechet_distance(fr, ff)
    if "kernel" in metrics:
        out["kernel"] = kernel_distance(fr, ff)
    if "prdc" in metrics:
        out.update(prdc(fr, ff))
    return out


@torch.no_grad()
def video_vs_generator(video_frames, G, n_samples: int = 256, batch_size: int = 16, seed: int = 0, extractor=None,
                       size: int = 128) -> dict:
    """OOD of rendered video frames against fresh samples of the generator
    ``G`` (a ``gan.wrapper.StyleGAN2``), on G's device: ``n_samples`` z's drawn
    on the CPU (batch i from ``fold_in(PRNGKey(seed), i)``), rendered, both
    sets resized to ``size`` (bilinear, antialiased, as ``jax.image.resize``),
    then the metric battery of :func:`compute`."""
    from ..generate import keys
    from ..ops.resize import resize

    device = G.mapper.device
    fakes = []
    for i in range(0, n_samples, batch_size):
        b = min(batch_size, n_samples - i)
        z = keys.normal(keys.fold_in(keys.PRNGKey(seed), i), (b, 512))
        img = torch.clamp((G.synthesizer(G.mapper(z)) + 1) / 2, 0, 1)
        fakes.append(resize(img, (b, size, size, 3), method="bilinear"))
    fakes = torch.cat(fakes)

    reals = _to_nhwc(video_frames, device)
    if reals.shape[1] != size:
        reals = resize(reals, (reals.shape[0], size, size, 3), method="bilinear")
    return compute(reals, fakes, extractor=extractor, device=device)
