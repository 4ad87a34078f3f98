"""On-the-fly feature-reactive latent targets (the "latent augmenter").

Counterpart of ``ssar_tpu/train/latent_augmenter.py``: pseudo ground-truth
W+ sequences made straight from audio features (a spline-looped base plus
feature-modulated patches over random W+ layer bands), for supervised
training with unlimited targets that correlate with the audio.  The random
choices thread ``generate/keys.py`` keys as the JAX package threads
``jax.random`` keys; the feature columns follow the 59-dim layout.
"""
from __future__ import annotations

import torch

from ..audio.processing import normalize
from ..generate import keys
from ..generate.latent import spline_loop_latents

FEAT_IDXS = {
    "chroma": (20, 32),
    "tonnetz": (32, 38),
    "onsets": (46, 47),
    "onsets_low": (47, 48),
    "onsets_mid": (48, 49),
    "onsets_high": (49, 50),
    "volume": (51, 52),
    "volume_low": (52, 53),
    "volume_mid": (53, 54),
    "volume_high": (54, 55),
    "volume_long": (55, 56),
    "volume_low_long": (56, 57),
    "volume_mid_long": (57, 58),
    "volume_high_long": (58, 59),
}
SINGLE_KEYS = [k for k, (a, b) in FEAT_IDXS.items() if b - a == 1]


class LatentAugmenter:
    """``mapper`` maps z (N, 512) to W+ (N, n_w, 512) on `device` (the
    StyleGAN2Mapper's device); n_ws latents are drawn from `seed`."""

    def __init__(self, mapper, n_patches: int = 5, n_ws: int = 16384, seed: int = 0, device=None):
        self.n_patches = n_patches
        device = device if device is not None else getattr(mapper, "device", None)
        self.ws = torch.as_tensor(mapper(keys.normal(keys.PRNGKey(seed), (n_ws, 512), device=device)))
        self.num = n_ws
        self.nw = self.ws.shape[1]
        self.keys = list(FEAT_IDXS)

    def _pick(self, key, n: int) -> torch.Tensor:
        return self.ws[keys.randint(key, 0, self.num, shape=(n,), device=self.ws.device)]

    def random_patch(self, feature: torch.Tensor, key):
        """feature (T, 59) -> (residual (T, n_w, 512), offset (1, n_w, 512))."""
        feature = torch.as_tensor(feature, dtype=torch.float32, device=self.ws.device)
        kit = iter(keys.split(key, 3 * self.n_patches + 2))
        T = feature.shape[0]
        n_base = int(keys.randint(next(kit), 3, 12))
        latent = spline_loop_latents(self._pick(next(kit), n_base), T)
        for _ in range(self.n_patches):
            k1, k2, k3 = next(kit), next(kit), next(kit)
            start, stop = FEAT_IDXS[self.keys[int(keys.randint(k1, 0, len(self.keys)))]]
            if float(keys.uniform(k2)) > 0.5:
                lay_start = int(keys.randint(k3, 0, self.nw - 6))
                lay_stop = int(keys.randint(keys.fold_in(k3, 1), lay_start + 1, self.nw + 1))
            else:
                lay_start, lay_stop = 0, self.nw
            lays = slice(lay_start, lay_stop)
            latent = latent.clone()
            if stop - start == 1:
                lat = self._pick(keys.fold_in(k2, 2), 1)
                modulation = normalize(feature[:, start:stop, None])
                latent[:, lays] = latent[:, lays] * (1 - modulation) + modulation * lat[:, lays]
            else:
                lats = self._pick(keys.fold_in(k2, 3), stop - start)
                modulation = normalize(feature[:, start:stop])
                modulation = modulation / (modulation.sum(dim=1, keepdim=True) + 1e-8)
                patch_latent = torch.einsum("ta,awl->twl", modulation, lats)
                if float(keys.uniform(keys.fold_in(k2, 4))) > 0.666:
                    name = SINGLE_KEYS[int(keys.randint(keys.fold_in(k2, 5), 0, len(SINGLE_KEYS)))]
                    a, b = FEAT_IDXS[name]
                    inter = normalize(feature[:, a:b, None])
                    latent[:, lays] = latent[:, lays] * (1 - inter) + inter * patch_latent[:, lays]
                else:
                    latent[:, lays] = patch_latent[:, lays]
        offset = latent.mean(dim=(0, 1), keepdim=True)
        return latent - offset, offset

    def __call__(self, features, key=None):
        """features (B, T, 59) -> (residuals (B, T, n_w, 512), offsets (B, 1, n_w, 512))."""
        key = key if key is not None else keys.PRNGKey(0)
        out = [self.random_patch(f, keys.fold_in(key, i)) for i, f in enumerate(features)]
        return torch.stack([r for r, _ in out]), torch.stack([o for _, o in out])
