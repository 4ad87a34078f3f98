"""Random audio-reactive patch: a seeded composition of latent and noise subpatches.

Counterpart of ``ssar_tpu/generate/patch.py``: a seed draws 5-20 latent
subpatches (segmentation / feature / loop x average / modulate x 6 bands of
W+ layers) and 5-20 noise subpatches (blend / multiply / loop), applied over
a spline-looped base sequence.  Draws go through ``keys``: one seed gives the
same patch structure on every device; the noise banks are the device's own
stream.  ``save`` / ``load`` write and read the JSON of the JAX package, so a
patch file moves between the two packages.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import keys
from .latent import latent_patch, spline_loop_latents
from .mir import ALLFEATS, UNITFEATS
from .noise import Loop, noise_patch

NOISE_SIZES = [4, 8, 8, 16, 16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 512, 1024, 1024]


class KeyGen:
    """Sequential key splitter: each call returns a fresh subkey."""

    def __init__(self, seed: int):
        self.key = keys.PRNGKey(seed)

    def __call__(self):
        self.key, sub = keys.split(self.key)
        return sub


def random_choice(kg: KeyGen, options, weights=None):
    if weights is None:
        idx = keys.randint(kg(), 0, len(options))
    else:
        p = torch.as_tensor(weights, dtype=torch.float32)
        idx = keys.choice(kg(), len(options), p / p.sum())
    return options[int(idx)]


def skewnorm(kg: KeyGen, a: float, loc: float, scale: float) -> float:
    """Skew-normal sample (the reference's hand-rolled sampler)."""
    u0 = float(keys.normal(kg()))
    v = float(keys.normal(kg()))
    d = a / np.sqrt(1 + a**2)
    u1 = d * u0 + v * np.sqrt(1 - d**2)
    return float(loc + scale * (u1 if u0 >= 0 else -u1))


class Patch:
    def __init__(self, features, segmentations, tempo, fps: float = 24, seed: int = 42,
                 min_subpatches: int = 5, max_subpatches: int = 20):
        self.seed = seed
        self.fps = fps
        self.tempo = tempo
        self.features = features
        self.segmentations = segmentations
        self.length = next(iter(features.values())).shape[0]

        kg = KeyGen(seed)
        self.num_base_latents = int(keys.randint(kg(), 3, 15))
        self.sigma_base_noise = 1 + 9 * float(keys.uniform(kg()))
        self.loops_base_noise = random_choice(kg, [1, 2, 4, 8, 16, 32, 64])

        self.ks = sorted({k for (_, k) in segmentations})
        n_lat = int(keys.randint(kg(), min_subpatches, max_subpatches))
        self.latent_patches = [self._random_latent_patch(kg) for _ in range(n_lat)]
        n_noise = int(keys.randint(kg(), min_subpatches, max_subpatches))
        self.noise_patches = [self._random_noise_patch(kg) for _ in range(n_noise)]

    def _random_latent_patch(self, kg: KeyGen) -> dict:
        return dict(
            patch_type=random_choice(kg, ["segmentation", "feature", "loop"]),
            segments=random_choice(kg, self.ks),
            loop_bars=random_choice(kg, [4, 8, 16, 32], weights=[2, 2, 2, 1]),
            seq_feat=random_choice(kg, ALLFEATS),
            seq_feat_weight=skewnorm(kg, a=5, loc=0.666, scale=0.5),
            mod_feat=random_choice(kg, UNITFEATS),
            mod_feat_weight=skewnorm(kg, a=5, loc=0.666, scale=0.5),
            merge_type=random_choice(kg, ["average", "modulate"], weights=[1, 3]),
            merge_depth=random_choice(kg, ["low", "mid", "high", "lowmid", "midhigh", "all"],
                                      weights=[3, 3, 3, 2, 2, 1]),
        )

    def _random_noise_patch(self, kg: KeyGen) -> dict:
        return dict(
            patch_type=random_choice(kg, ["blend", "multiply", "loop"]),
            loop_bars=random_choice(kg, [4, 8, 16, 32], weights=[2, 2, 2, 1]),
            seq_feat=random_choice(kg, ALLFEATS),
            seq_feat_weight=skewnorm(kg, a=5, loc=0.666, scale=0.5),
            mod_feat=random_choice(kg, UNITFEATS),
            mod_feat_weight=skewnorm(kg, a=5, loc=0.666, scale=0.5),
            merge_type=random_choice(kg, ["average", "modulate"], weights=[1, 3]),
            merge_depth=random_choice(kg, ["low", "mid", "high", "lowmid", "midhigh", "all"],
                                      weights=[3, 3, 3, 2, 2, 1]),
            noise_mean=float(keys.normal(kg())) * 0.5,
            noise_std=skewnorm(kg, a=5, loc=0.666, scale=0.5),
        )

    def update_intensity(self, val: float):
        """Re-draw the reactivity weights around `val`."""
        kg = KeyGen(self.seed + 1)
        for p in self.latent_patches:
            p["seq_feat_weight"] = skewnorm(kg, a=5, loc=val, scale=0.5)
            p["mod_feat_weight"] = skewnorm(kg, a=5, loc=val, scale=0.5)
        for p in self.noise_patches:
            p["seq_feat_weight"] = skewnorm(kg, a=5, loc=val, scale=0.5)
            p["mod_feat_weight"] = skewnorm(kg, a=5, loc=val, scale=0.5)
            p["noise_std"] = skewnorm(kg, a=5, loc=val, scale=0.5)

    def forward(self, latent_palette, downscale_factor: float = 1, aspect_ratio: float = 1):
        """palette (P, n_ws, 512) -> (latents (T, n_ws, 512), one noise
        module per layer).  Re-seeded on every call, so two calls give the
        same sequences; everything lives on the palette's device."""
        kg = KeyGen(self.seed)
        device = latent_palette.device

        base_sel = keys.permutation(kg(), latent_palette.shape[0])[: self.num_base_latents].to(device)
        latents = spline_loop_latents(latent_palette[base_sel], self.length)
        for subpatch in self.latent_patches:
            latents = latent_patch(kg(), latents, latent_palette, self.segmentations,
                                   self.features, self.tempo, self.fps, **subpatch)

        noise = [
            Loop(kg(), self.length,
                 (round(aspect_ratio * size / downscale_factor), round(size / downscale_factor)),
                 n_loops=self.loops_base_noise, sigma=self.sigma_base_noise, device=device)
            for size in NOISE_SIZES
        ]
        for subpatch in self.noise_patches:
            noise = noise_patch(kg(), noise, self.features, self.tempo, self.fps, **subpatch)

        return latents, noise

    __call__ = forward

    def __repr__(self):
        rows = []
        for patches, title in [(self.latent_patches, "Latent"), (self.noise_patches, "Noise")]:
            rows.append(f"  {title}(")
            for i, p in enumerate(patches):
                body = ", ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                                 for k, v in p.items())
                rows.append(f"    {i + 1}: {body}")
            rows.append("  )")
        return "Patch(\n" + "\n".join(rows) + "\n)"

    def save(self, path: str):
        state = dict(seed=self.seed,
                     latent_patches=self.latent_patches, noise_patches=self.noise_patches,
                     num_base_latents=self.num_base_latents,
                     sigma_base_noise=self.sigma_base_noise,
                     loops_base_noise=self.loops_base_noise)
        with open(path, "w") as f:
            f.write(json.dumps(state, default=lambda o: int(o) if hasattr(o, "item") else str(o)))

    @staticmethod
    def load(path: str, features, segmentations, tempo, fps, **kw):
        patch = Patch(features, segmentations, tempo, fps=fps, **kw)
        with open(path) as f:
            info = json.loads(f.read())
        for key, val in info.items():
            setattr(patch, key, val)
        return patch
