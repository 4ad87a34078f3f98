"""Absolute FID / KID / PRDC through the trained in-environment extractor, on
the port.

Counterpart of ``scripts/ood_absolute.py``.  The reference's OOD evaluation
(ssar/ood.py:80-206) runs FID-family metrics through a pretrained SwAV trunk;
with no pretrained weights in the repository, this runs them through the
calibration run's trained StyleGAN2 discriminator
(``scripts.train_calibration_g``) and checks three rows of known order:

- null:       two disjoint halves of the real distribution (small);
- generator:  calibration-G renders against the real procedural targets;
- corrupted:  real targets with channel-rolled colours (worse than the
              generator on this colour-sensitive extractor).

    python -m ssar_tpu_torch.scripts.ood_absolute

Reads docs/study/calibration_g.npz and calibration_d.npz by default and
writes output/ood_absolute.json (not docs/, which holds the committed run).
Runs on the CUDA device unless ``--device`` says otherwise.  The z draws are
made on the CPU (``generate/keys.py``), so they are the same on every device.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

BATCH = 32


def z_draws(key, n_batches: int, style_dim: int = 512, batch_size: int = BATCH) -> list:
    """`n_batches` (batch_size, style_dim) standard-normal z, batch i from
    ``fold_in(key, i)``, on the CPU."""
    from ..generate import keys

    return [keys.normal(keys.fold_in(key, i), (batch_size, style_dim)) for i in range(n_batches)]


@torch.no_grad()
def image_batch(g_params: dict, config, z: torch.Tensor, P: torch.Tensor | None = None,
                dtype=torch.bfloat16) -> torch.Tensor:
    """z (B, style_dim) -> images (B, R, R, 3) in [0, 1] on the generator's
    device: the procedural targets of the mapped z when the target basis `P`
    is given (the real distribution), else the calibration G's renders, its
    synthesis in `dtype`."""
    from ..gan import stylegan2 as sg
    from ..train.palette_g import procedural_targets

    w = sg.mapping(g_params, z.to(g_params["const"].device), config)
    if P is not None:
        img = procedural_targets(w, P, config.resolution)
    else:
        img = sg.synthesis(g_params, sg.w_to_wplus(w, config), None, config, dtype=dtype)
    return torch.clamp((img + 1) / 2, 0, 1)


def main(argv=None) -> dict:
    """The three rows; writes `--out` and prints the ordering check."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--g", default="docs/study/calibration_g.npz")
    ap.add_argument("--d", default="docs/study/calibration_d.npz")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--max_channels", type=int, default=128)
    ap.add_argument("--out", default="output/ood_absolute.json")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..gan import stylegan2 as sg
    from ..gan.convert import load_npz, load_npz_tree
    from ..generate import keys
    from ..metrics.ood import compute, discriminator_extractor
    from ..train.palette_g import target_basis
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"device: {device}")
    config = sg.StyleGAN2Config(resolution=args.resolution, max_channels=args.max_channels)
    g_params = load_npz(args.g, device=device)
    extractor = discriminator_extractor(load_npz_tree(args.d), resolution=args.resolution)

    P = target_basis(config.style_dim, device=device)
    k_real, k_fake = keys.split(keys.PRNGKey(11))

    t0 = time.time()
    # real: procedural targets over mapped latents (the training distribution)
    real = torch.cat([image_batch(g_params, config, z, P)
                      for z in z_draws(k_real, 2 * args.n // BATCH, config.style_dim)])
    fake = torch.cat([image_batch(g_params, config, z) for z in z_draws(k_fake, args.n // BATCH, config.style_dim)])
    corrupted = real[args.n :][..., [2, 0, 1]]  # channel-rolled colours

    rows = {
        "null (real half vs real half)": compute(real[: args.n], real[args.n :], extractor=extractor, device=device),
        "calibration G vs real targets": compute(real[: args.n], fake, extractor=extractor, device=device),
        "corrupted (channel-rolled) vs real": compute(real[: args.n], corrupted, extractor=extractor,
                                                      device=device),
    }
    wall = time.time() - t0
    result = {"extractor": "trained calibration D penultimate (512-d)",
              "n": args.n, "resolution": args.resolution, "wall_s": round(wall, 1),
              "rows": {k: {m: (round(float(x), 4) if isinstance(x, float) else x)
                           for m, x in v.items()} for k, v in rows.items()}}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps(result, indent=2))
    ok = (rows["null (real half vs real half)"]["frechet"]
          < rows["calibration G vs real targets"]["frechet"]
          < rows["corrupted (channel-rolled) vs real"]["frechet"])
    print("ordering (null < G < corrupted):", "OK" if ok else "VIOLATED")
    return {**result, "ordering_ok": bool(ok)}


if __name__ == "__main__":
    main()
