"""Train the in-environment calibration G (and its D) on the port.

Counterpart of ``scripts/train_calibration_g.py``: the in-repo generator and
discriminator trained on procedural structured-colour targets that are
smooth functions of W (``train/palette_g.py``), so that W latents get a
consistent palette identity the study's scorer can see.

    python -m ssar_tpu_torch.scripts.train_calibration_g --out output/calibration_g

Writes <out>/calibration_g.npz and calibration_d.npz (float16, JAX layout:
``ssar_tpu.gan.convert.load_npz`` reads them, as does the port's
``gan.convert.load_npz`` / ``load_npz_tree``), calibration_g_curve.json
(loss curves, identity spread, target alignment) and, where matplotlib is
installed, calibration_g_samples.png (8 random latents and a row of convex
mixes).  The default ``--out`` is not ``docs/study``, which holds the
committed checkpoint of record.  Runs on the CUDA device unless
``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


@torch.no_grad()
def sample_grid(params, config, path: str, n: int = 8, seed: int = 7) -> None:
    """Row 1: `n` random latents; row 2: convex palette mixes from w[0] to
    w[1] (the chroma recipe's mechanism), rendered in bf16."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..gan import stylegan2 as sg
    from ..generate import keys
    from ..generate.latent import linspace

    device = params["const"].device
    z = keys.normal(keys.PRNGKey(seed), (n, config.style_dim), device=device)
    w = sg.mapping(params, z, config)
    alphas = linspace(1.0, n, device)[:, None]   # jnp.linspace(0, 1, n)
    w_mix = (1 - alphas) * w[0:1] + alphas * w[1:2]
    imgs = sg.synthesis(params, sg.w_to_wplus(torch.cat([w, w_mix]), config), None, config, dtype=torch.bfloat16)
    imgs = np.clip((imgs.float().cpu().numpy() + 1) / 2, 0, 1)
    fig, axes = plt.subplots(2, n, figsize=(2 * n, 4.2))
    for i in range(n):
        axes[0, i].imshow(imgs[i]); axes[0, i].set_axis_off()
        axes[1, i].imshow(imgs[n + i]); axes[1, i].set_axis_off()
    axes[0, 0].set_title("random latents", loc="left", fontsize=9)
    axes[1, 0].set_title("convex mix w0 -> w1 (chroma mechanism)", loc="left", fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def main(argv=None) -> dict:
    """Train, write the checkpoints, the curve JSON and the sample grid;
    returns the curve JSON's record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/calibration_g")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--max_channels", type=int, default=128)
    ap.add_argument("--n_steps", type=int, default=3000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--lambda_adv", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..gan.convert import save_npz
    from ..gan.discriminator import discriminator_flax_tree
    from ..gan.stylegan2 import StyleGAN2Config
    from ..train.palette_g import palette_identity_spread, palette_target_alignment, train_calibration_g
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"device: {device}")
    config = StyleGAN2Config(resolution=args.resolution, max_channels=args.max_channels)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    params, D, losses = train_calibration_g(
        config, n_steps=args.n_steps, batch_size=args.batch_size, lr=args.lr,
        lambda_adv=args.lambda_adv, seed=args.seed, device=device)
    wall = time.time() - t0

    spread = palette_identity_spread(params, config)
    alignment = palette_target_alignment(params, config)
    # f16 storage compression; load_npz promotes back to f32
    ckpt = out / "calibration_g.npz"
    save_npz(str(ckpt), params, dtype=np.float16)
    if D is not None:  # the trained D doubles as the in-environment OOD feature extractor
        save_npz(str(out / "calibration_d.npz"), {"params": discriminator_flax_tree(D)}, dtype=np.float16)
    n_params = _numel(params)
    record = {
        "config": {"resolution": args.resolution, "max_channels": args.max_channels,
                   "n_steps": args.n_steps, "batch_size": args.batch_size,
                   "lr": args.lr, "lambda_adv": args.lambda_adv, "seed": args.seed},
        "n_params": n_params, "wall_s": round(wall, 1),
        "identity_spread": spread, "target_alignment": alignment,
        "mse": losses["mse"][::10], "d_loss": losses["d_loss"][::10],
        "g_adv": losses["g_adv"][::10],
    }
    (out / "calibration_g_curve.json").write_text(json.dumps(record, indent=2))
    try:
        sample_grid(params, config, str(out / "calibration_g_samples.png"))
    except ImportError as e:   # the grid is a figure: written where matplotlib is installed
        print(f"sample grid skipped: {e}")
    print(f"trained {n_params / 1e6:.1f}M params in {wall:.0f}s; "
          f"final mse {losses['mse'][-1]:.4f}; target alignment {alignment:.3f}; "
          f"checkpoint {ckpt} ({ckpt.stat().st_size / 1e6:.1f} MB)")
    return record


if __name__ == "__main__":
    main()
