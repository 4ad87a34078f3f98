"""Checkpoint evaluation: split renders, long-form generation, sensitivity.

Counterpart of ``ssar_tpu/train/evaluate.py``:
- ``load_checkpoint`` rebuilds a reactor from one of the port's training runs
  (``train/train.py``: ``ckpt/step_*.pt``, ``config.json``, ``input_mean.npy``
  / ``input_std.npy``) with the stored flags;
- ``generate_by_data_split``: clips rendered from dataset windows;
- ``generate_longform``: a whole track in one reactor pass;
- ``feature_sensitivity``: zero / invert / permute / double one feature
  column at a time and measure the change of the predicted latents.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..utils.config import Config
from ..utils.device import resolve_device

N_FEATURES = 59


def _checkpoint_file(run_dir: Path, step: int | None) -> Path:
    if step is not None:
        return run_dir / "ckpt" / f"step_{int(step):09d}.pt"
    ckpts = sorted((run_dir / "ckpt").glob("step_*.pt"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/ckpt")
    return ckpts[-1]


def checkpoint_steps(run_dir) -> list[int]:
    """The steps of a run's checkpoints, ascending."""
    return sorted(int(p.stem.removeprefix("step_")) for p in (Path(run_dir) / "ckpt").glob("step_*.pt"))


def load_checkpoint(run_dir: str, step: int | None = None, device: str | torch.device | None = None):
    """-> (model, config) from a run directory of the port's trainer, the
    model in eval mode on `device` (the CUDA device unless given).

    The reactor is rebuilt by the trainer's own ``make_model`` from the
    stored flags, so every flag the run used (backbone, decoder, noise mode,
    dropout, ...) holds; a sectioned ``config.json`` (the ``Config`` tree)
    supplies its model section instead, and ``config`` is that ``Config``
    (None for the trainer's flat flag dump).  ``step`` picks
    ``ckpt/step_<step>.pt`` (the latest when None).  The input normalisation
    and the fixed decoder's palette are buffers of the model, so they come
    from the checkpoint (``input_mean.npy`` / ``input_std.npy``, or the
    identity for runs without them, only build the model before the load).
    Runs of the JAX
    package's trainer (Orbax checkpoints) cannot be read here: Orbax imports
    JAX.
    """
    from .train import build_parser, make_model

    device = resolve_device(device)
    run_dir = Path(run_dir)
    args = build_parser().parse_args([])
    cfg = None
    cfg_path = run_dir / "config.json"
    if cfg_path.exists():
        raw = json.loads(cfg_path.read_text())
        if "model" in raw:
            cfg = Config.from_dict(raw)
            flags = {k: getattr(cfg.model, k) for k in ("backbone", "hidden_size", "num_layers", "decoder",
                                                         "n_latent_split", "residual", "dropout")}
        else:  # the trainer's argparse dump
            flags = raw
        for k, v in flags.items():
            if hasattr(args, k):
                setattr(args, k, v)

    if (run_dir / "input_mean.npy").exists():
        mean, std = np.load(run_dir / "input_mean.npy"), np.load(run_dir / "input_std.npy")
    else:  # older runs: identity normalisation
        mean, std = np.zeros(N_FEATURES, np.float32), np.ones(N_FEATURES, np.float32)
    state = torch.load(_checkpoint_file(run_dir, step), map_location="cpu", weights_only=True)["params"]
    model = make_model(args, mean, std, state.get("decoder.latents"))
    model.load_state_dict(state)
    return model.to(device).eval(), cfg


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def generate_by_data_split(run_dir: str, dataset, out_dir: str, n_per_split: int = 2, fps: int = 24,
                           gan_config=None, model_file=None, output_size=(256, 256),
                           device: str | torch.device | None = None) -> list:
    """Render clips of the first `n_per_split` windows of `dataset` through
    the run's latest checkpoint to ``<out_dir>/split_render_<i>.mp4``; window
    i's base noise comes from a generator seeded with i.  Returns the
    writers."""
    from ..generate.audio2video import react, render_reaction

    model, _ = load_checkpoint(run_dir, device=device)
    device = _model_device(model)
    outs = []
    for i in range(min(n_per_split, len(dataset))):
        feats = torch.as_tensor(np.asarray(dataset.features[i]), dtype=torch.float32).to(device)
        latents, noise = react(model, feats, torch.Generator(device).manual_seed(i))
        out_file = str(Path(out_dir) / f"split_render_{i}.mp4")
        outs.append(render_reaction(latents, noise, out_file, model_file=model_file, output_size=output_size,
                                    fps=fps, gan_config=gan_config))
    return outs


def generate_longform(run_dir: str, audio, sr: int, out_file: str | None = None, fps: int = 24, gan_config=None,
                      model_file=None, output_size=(256, 256), batch_size: int = 8,
                      device: str | torch.device | None = None, writer=None):
    """Whole-track inference in one reactor pass (base noise seeded 0), then
    the render into `writer` (or an mp4 at `out_file`).  Returns the writer."""
    from ..audio.features import audio2features
    from ..generate.audio2video import react, render_reaction

    model, _ = load_checkpoint(run_dir, device=device)
    device = _model_device(model)
    feats = audio2features(audio, int(sr), fps, device=device)
    latents, noise = react(model, feats, torch.Generator(device).manual_seed(0))
    return render_reaction(latents, noise, out_file, model_file=model_file, output_size=output_size, fps=fps,
                           batch_size=batch_size, gan_config=gan_config, writer=writer)


def _permute(col: torch.Tensor, key) -> torch.Tensor:
    from ..generate import keys

    return col[keys.permutation(key, col.shape[0]).to(col.device)]


PERTURBATIONS = {
    "zero": lambda col, key: torch.zeros_like(col),
    "invert": lambda col, key: col.max() - col,
    "random": _permute,
    "scale2x": lambda col, key: 2.0 * col,
}


@torch.no_grad()
def feature_sensitivity(model, features, feature_names=None,
                        perturbations=("zero", "invert", "random", "scale2x"), seed: int = 0) -> dict:
    """Mean |change| of the predicted latents when one feature column of
    `features` (T, F) is perturbed, for every column and perturbation:
    {(feature, perturbation): float}.  Every forward (eval mode) draws its
    base noise from a generator seeded with `seed`; "random" permutes column
    i with the key of ``seed + i``.  The deltas stay on the model's device
    until one read at the end."""
    from ..generate import keys

    model.eval()
    device = _model_device(model)
    feats = torch.as_tensor(features, dtype=torch.float32).to(device)[None]
    T, F = feats.shape[1], feats.shape[2]

    def latents(x):
        return model(x, generator=torch.Generator(device).manual_seed(seed))[0]

    base = latents(feats)
    names = feature_names or [f"f{i}" for i in range(F)]
    # the permutations' keys drawn up front and sent once (a copy a column would wait on the card each time)
    perms = None
    if "random" in perturbations:
        perms = torch.stack([keys.permutation(keys.PRNGKey(seed + i), T) for i in range(F)]).to(device)
    deltas = []
    for i in range(F):
        col = feats[0, :, i]
        for p in perturbations:
            new_col = col[perms[i]] if p == "random" else PERTURBATIONS[p](col, keys.PRNGKey(seed + i))
            x = feats.clone()
            x[0, :, i] = new_col
            deltas.append((latents(x) - base).abs().mean())
    values = torch.stack(deltas).cpu().tolist() if deltas else []
    pairs = [(names[i], p) for i in range(F) for p in perturbations]
    return dict(zip(pairs, values))
