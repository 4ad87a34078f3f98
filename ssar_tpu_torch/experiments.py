"""The paper's experiment grid through the port's trainer.

Counterpart of ``experiments.py`` at the repository's root: the same grids,
cell for cell (the reference's configs of record: GRU backbones, 4-6 layers,
hidden 3-32, batch 32, lr 1e-4, 128k examples, 8 s windows at 24 fps), each
cell launched through ``ssar_tpu_torch.train.train.main`` with the same
flags, run directory, eval and checkpoint cadence, and the results gathered
into ``<grid>_results.json`` (and ``.csv`` where pandas is installed), which
``scripts/collect_grid.py`` reads.  Runs on the CUDA device unless
``--device`` says otherwise; with neither, it raises before the first cell.

    python -m ssar_tpu_torch.experiments --grid smoke --device cpu
    python -m ssar_tpu_torch.experiments --grid record   # after scripts.make_record_dataset
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

GRIDS = {
    # the reference's configs of record (experiments.sh)
    "paper": {
        "backbone": ["gru", "sashimi"],
        "decoder": ["fixed", "learned"],
        "loss": ["supervised", "selfsupervised", "ssabsdiff"],
        "hidden_size": [8, 16, 32],
        "num_layers": [4, 6],
        "n_examples": [128_000],
        "lr": [1e-4],
        "batch_size": [32],
    },
    # the run-of-record subset: the GRU reactor at the reference's flagship
    # width, all three loss modes, 128k examples over the record corpus
    # (python -m ssar_tpu_torch.scripts.make_record_dataset)
    "record": {
        "backbone": ["gru"],
        "decoder": ["fixed"],
        "loss": ["supervised", "selfsupervised", "ssabsdiff"],
        "hidden_size": [32],
        "num_layers": [4],
        "n_examples": [128_000],
        "lr": [1e-4],
        "batch_size": [32],
        "_extra": {"cache_dir": "data/record/cache", "render_size": 256},
    },
    # the reference's own supervised record config (experiments.sh:4-5:
    # fixed decoder, hidden 3), unstable under its unguarded envelope
    # normalisation (docs/GRID.md)
    "record_h3": {
        "backbone": ["gru"],
        "decoder": ["fixed"],
        "loss": ["supervised"],
        "hidden_size": [3],
        "num_layers": [4],
        "n_examples": [128_000],
        "lr": [1e-4],
        "batch_size": [32],
        "_extra": {"cache_dir": "data/record/cache", "render_size": 256},
    },
    # the same h3 config with the opt-in envelope guard
    "record_h3g": {
        "backbone": ["gru"],
        "decoder": ["fixed"],
        "loss": ["supervised"],
        "hidden_size": [3],
        "num_layers": [4],
        "n_examples": [128_000],
        "lr": [1e-4],
        "batch_size": [32],
        "_extra": {"cache_dir": "data/record/cache", "render_size": 256,
                   "env_guard_eps": 1e-2},
    },
    "smoke": {
        "backbone": ["gru", "mlp"],
        "decoder": ["learned"],
        "loss": ["supervised"],
        "hidden_size": [8],
        "num_layers": [2],
        "n_examples": [256],
        "lr": [1e-3],
        "batch_size": [8],
    },
}

# extras that only place data or size the checkpoint render: they name no cell
_UNTAGGED = ("cache_dir", "render_size")


def run_grid(name: str, out_dir: str = "runs/experiments", device: str | None = None, grid: dict | None = None):
    """Train every cell of ``GRIDS[name]`` (or of `grid`, given under that
    name) and return its result rows; ``<out_dir>/<name>_results.json`` is
    rewritten after each cell.  A cell that raises is recorded with its
    error and the grid goes on."""
    from .train.train import main as train_main
    from .utils.device import resolve_device

    resolve_device(device)   # no CUDA device and no `device`: raise here, not once per cell

    grid = dict(GRIDS[name] if grid is None else grid)
    extra = grid.pop("_extra", {})
    # model-affecting extras (e.g. env_guard_eps) get their own cell directory
    tagged = {k: v for k, v in extra.items() if k not in _UNTAGGED}
    tag = "_".join(f"{k}-{v}" for k, v in tagged.items())
    keys = list(grid)
    results = []
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for values in itertools.product(*grid.values()):
        cfg = dict(zip(keys, values))
        run_id = "_".join(f"{k}-{v}" for k, v in cfg.items())
        if tag:
            run_id += "_" + tag
        print(f"\n=== {run_id} ===")
        t0 = time.time()
        argv = []
        for k, v in {**cfg, **extra}.items():
            argv += [f"--{k}", str(v)]
        argv += ["--out_dir", str(out / run_id), "--eval_every", str(max(64, cfg["n_examples"] // 10)),
                 "--ckpt_every", str(cfg["n_examples"])]
        if device is not None:
            argv += ["--device", str(device)]
        try:
            log_dir, val_loss = train_main(argv)
            row = {**cfg, **tagged, "val_loss": val_loss, "seconds": time.time() - t0, "log_dir": str(log_dir)}
            final = Path(log_dir) / "final_metrics.json"
            if final.exists():  # the per-window median beside the mean (docs/GRID.md)
                row.update(json.loads(final.read_text()))
            results.append(row)
        except Exception as e:
            results.append({**cfg, "error": str(e)[:200]})
        (out / f"{name}_results.json").write_text(json.dumps(results, indent=2))

    try:
        import pandas as pd

        pd.DataFrame(results).to_csv(out / f"{name}_results.csv")
    except ImportError:
        pass
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid", default="smoke", choices=list(GRIDS))
    p.add_argument("--out_dir", default="runs/experiments")
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file; explicit CLI flags override it")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    if args.config:
        from .utils.config import apply_config_file

        args = apply_config_file(p, args, args.config, argv)
    return run_grid(args.grid, args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
