"""The compare-big-three study on the port.

Counterpart of ``scripts/run_study.py``, the reference's end product
(ssar/comparison.py:443-555): for a test set of clips, every generation
paradigm predicts a latent + noise sequence (the random patch; the grid's
trained GRU reactors, one per loss mode; per-track self-supervised
optimization, also with the motion-amplitude prior; the LucidSonicDreams
recipe, also at 1/5 of its amplitudes), each prediction is rendered and
scored with the 9-audio x 12-video feature battery (1 - procrustes
distance), and a forward-only pass times each model's inference.  The
scorer is calibrated first on the known-correlation recipe videos
(``metrics/generate.py``).  A grid checkpoint whose final validation loss
exceeds ``--max_val_loss`` (a collapsed model) is refused.

    python -m ssar_tpu_torch.scripts.run_study --out output/study --grid_dir runs/experiments

Writes <out>/{study/, study.csv, runtimes/, runtimes.csv, calibration.json,
ssopt_curves.json, ssopt_curves_amp.json, summary.json} and, where
matplotlib is installed, heatmap_<model>.png; ``scripts/collect_study.py``
turns them into docs.  Runs on the CUDA device unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .make_record_dataset import FPS, SR, synth_track

N_CLIPS = 6
CLIP_SECONDS = 16
SSOPT_STEPS = 512   # the comparison optimizer's steps a clip


def build_models(G, grid_dir: Path, max_val_loss: float, model_file: str | None = None,
                 ssopt_steps: int = SSOPT_STEPS) -> dict:
    """The study's predictors on G's device: four baselines and, for each
    of the grid's hidden-32 GRU cells with a checkpointed run, its latest run
    (through ``train.evaluate.load_checkpoint``).  Raises ``SystemExit``
    when that run's final validation loss in ``record_results.json`` is not
    finite or exceeds `max_val_loss`."""
    from ..metrics.comparison import (LucidSonicBaseline, RandomGenerator, SelfSupervisedOptimization,
                                      SupervisedSequenceModel)
    from ..train.evaluate import load_checkpoint

    device = G.mapper.device
    models = {
        "random_patch": RandomGenerator(G, fps=FPS, seed=0),
        "lucid_baseline": LucidSonicBaseline(G, fps=FPS),
        # amplitude-sensitivity control: same recipe, 1/5 the kick sizes
        "lucid_low_amp": LucidSonicBaseline(G, fps=FPS, pulse_react=0.1, motion_react=0.1),
        # model_file: ssopt maps its own palette, so it must see the study G's checkpoint
        "ssopt": SelfSupervisedOptimization(fps=FPS, n_steps=ssopt_steps, gan_config=G.config,
                                            model_file=model_file, device=device),
        # the opt-in motion-amplitude term pinning mean |delta latent| to the
        # patch system's 0.048 a frame (the procrustes objective is scale-invariant)
        "ssopt_amp": SelfSupervisedOptimization(fps=FPS, n_steps=ssopt_steps, gan_config=G.config,
                                                model_file=model_file, lambda_amplitude=100.0, device=device),
    }

    # final val losses from the grid runner's results, for the collapsed-checkpoint guard
    val_by_dir = {}
    results_json = grid_dir / "record_results.json"
    if results_json.exists():
        for row in json.loads(results_json.read_text()):
            if "log_dir" in row:
                val_by_dir[Path(row["log_dir"]).name] = row.get("val_loss")

    for cell in sorted(grid_dir.glob("backbone-gru_*")):
        if "_hidden_size-32_" not in cell.name:
            continue  # h3 / guarded diagnostics cells are not study models
        loss = [p for p in cell.name.split("_") if p.startswith("loss-")][0][5:]
        runs = sorted(d for d in cell.iterdir() if (d / "ckpt").exists())
        if not runs:
            print(f"skipping {cell.name}: no checkpointed run")
            continue
        val = val_by_dir.get(runs[-1].name)
        if val is not None and (not np.isfinite(val) or val > max_val_loss):
            raise SystemExit(
                f"REFUSING checkpoint {runs[-1].name}: final val loss {val:.4g} exceeds "
                f"--max_val_loss {max_val_loss:.4g}: the model collapsed during training; "
                "re-run the grid (python -m ssar_tpu_torch.experiments --grid record) before the study")
        model, _ = load_checkpoint(str(runs[-1]), device=device)
        models[f"gru_{loss}"] = SupervisedSequenceModel(model, fps=FPS, G=G)
        print(f"loaded gru_{loss} from {runs[-1].name} (val loss {val})")
    return models


def run_calibration(G, clips, out: Path) -> tuple[dict, bool]:
    """Score the known-correlation recipe videos with the study's own
    battery (reference ssar/metrics/generate.py:60-174), rendered by G and
    resized to 128 px.  Returns ({recipe: {clip: record}}, whether it was
    read back from ``calibration.json``); asserts nothing."""
    from ..metrics.comparison import AFNS, VFN_NAMES, VFNS
    from ..metrics.generate import CORRELATION_RECIPES, render_correlation_clip
    from ..ops.resize import resize
    from ..train.losses import audio_reactive_loss

    path = out / "calibration.json"
    if path.exists():
        return json.loads(path.read_text()), True
    device = G.mapper.device
    results = {}
    with torch.no_grad():
        for recipe in CORRELATION_RECIPES:
            results[recipe] = {}
            for clip_name, audio, sr in clips:
                t0 = time.time()
                video = render_correlation_clip(recipe, audio, sr, G, fps=FPS, seed=7)
                video128 = resize(video.permute(0, 2, 3, 1), (video.shape[0], 128, 128, 3),
                                  method="bilinear").permute(0, 3, 1, 2)
                audio_t = torch.as_tensor(np.asarray(audio, np.float32)).to(device)
                vfeats = {n: fn(video128)[None] for n, fn in zip(VFN_NAMES, VFNS)}
                afeats = {fn.__name__: fn(audio_t, int(sr))[None] for fn in AFNS}
                corr = float(1 - audio_reactive_loss(afeats, vfeats)[0])
                # the channel-specific block: a chroma-only video has no counterpart motion for 7 of
                # the 9 audio features, so the chroma pairs are where that channel shows
                rec = {"overall": corr}
                pairs = []
                for an in ("chromagram", "tonnetz"):
                    for vn in ("rgb_hist", "hsv_hist"):
                        pc = float(1 - audio_reactive_loss([afeats[an]], [vfeats[vn]])[0])
                        rec[f"{an}|{vn}"] = pc
                        pairs.append(pc)
                rec["chroma_channel"] = float(np.mean(pairs))
                results[recipe][clip_name] = rec
                print(f"calibration {recipe}/{clip_name}: overall {corr:.4f} "
                      f"chroma_channel {rec['chroma_channel']:.4f} ({time.time() - t0:.0f}s)")
    path.write_text(json.dumps(results, indent=2))
    return results, False


def study(G, clips, models: dict, out: Path, skip_calibration: bool = False) -> dict:
    """Calibration on the first three clips, the battery, the ssopt curves,
    the forward-only pass, then ``summary.json`` and the heatmaps; returns
    the summary.  Records already under `out` are read back (a resumed run)."""
    from ..metrics.comparison import compare_models
    from ..utils.plot import correlation_heatmap

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    wall = {}

    t0 = time.time()
    if not skip_calibration:
        _, cached = run_calibration(G, clips[:3], out)
        # a resumed run records the cache hit, not 0 s
        wall["calibration_s"] = "cached" if cached else round(time.time() - t0, 1)

    n_before = len(list((out / "study").glob("*.json"))) if (out / "study").exists() else 0
    t0 = time.time()
    records = compare_models("study", models, clips, G, out_dir=str(out))
    wall["battery_s"] = ("cached" if len(records) == n_before and n_before > 0
                         else round(time.time() - t0, 1))
    print(f"correlation battery: {wall['battery_s']}s, {len(records)} records")

    # ssopt objective curves (captured during the battery), with their loss-sample stride
    for nm in ("ssopt", "ssopt_amp"):
        ssopt = models.get(nm)
        if ssopt is not None and getattr(ssopt, "loss_curves", None):
            suffix = "" if nm == "ssopt" else "_amp"
            (out / f"ssopt_curves{suffix}.json").write_text(json.dumps(
                {"log_steps": getattr(ssopt, "log_steps", 16), "curves": ssopt.loss_curves}, indent=2))

    t0 = time.time()
    runtimes = compare_models("runtimes", models, clips, G, out_dir=str(out), forward_only=True)
    wall["forward_only_s"] = round(time.time() - t0, 1)
    print(f"forward-only pass: {wall['forward_only_s']:.0f}s")

    # cached phases keep the wall clock of the run that paid for them
    prev_wall = {}
    if (out / "summary.json").exists():
        prev_wall = json.loads((out / "summary.json").read_text()).get("wall_clock", {})
    for k, v in wall.items():
        if v == "cached" and isinstance(prev_wall.get(k), (int, float)):
            wall[k] = prev_wall[k]
    summary = {"wall_clock": wall}
    if getattr(models.get("random_patch"), "mir_seconds", None):
        summary["wall_clock"]["patch_mir_s_per_clip"] = float(np.median(models["random_patch"].mir_seconds))
    plots = True
    for m in models:
        recs = [r for r in records if r["model_name"] == m]
        if recs:
            summary[m] = {
                "median_correlation": float(np.median([r["correlation"] for r in recs])),
                "mean_correlation": float(np.mean([r["correlation"] for r in recs])),
                "median_latent_correlation": float(
                    np.median([r["latent_correlation"] for r in recs if "latent_correlation" in r])
                    if any("latent_correlation" in r for r in recs) else float("nan")),
                "mean_latent_step": float(np.mean([r.get("mean_latent_step", np.nan) for r in recs])),
                "mean_pixel_step": float(np.mean([r.get("mean_pixel_step", np.nan) for r in recs])),
                "n_clips": len(recs),
            }
            if plots:
                try:
                    correlation_heatmap([{k: v for k, v in r.items() if "|" in k or k == "clip"} for r in recs],
                                        str(out / f"heatmap_{m}.png"))
                except ImportError as e:   # the heatmaps are figures: written where matplotlib is installed
                    print(f"heatmaps skipped: {e}")
                    plots = False
        rts = [r for r in runtimes if r["model_name"] == m]
        if rts and m in summary:
            summary[m]["inference_frames_per_s"] = float(np.median([r["n"] / max(r["time"], 1e-9) for r in rts]))
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/study")
    ap.add_argument("--grid_dir", default="runs/experiments")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--max_val_loss", type=float, default=2000.0,
                    help="refuse grid checkpoints whose final val loss exceeds this")
    ap.add_argument("--skip_calibration", action="store_true")
    ap.add_argument("--model_file", default=None,
                    help="G checkpoint (.npz), e.g. the calibration G of scripts.train_calibration_g; "
                         "None = random init")
    ap.add_argument("--max_channels", type=int, default=512,
                    help="G width cap; must match the checkpoint's config")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..gan.stylegan2 import StyleGAN2Config
    from ..gan.wrapper import StyleGAN2

    G = StyleGAN2(model_file=args.model_file, output_size=(args.resolution, args.resolution),
                  config=StyleGAN2Config(resolution=args.resolution, max_channels=args.max_channels), seed=0,
                  device=args.device)
    print(f"device: {G.mapper.device}")
    clips = [(f"clip{i}", synth_track(seed=2000 + i, seconds=CLIP_SECONDS), SR) for i in range(N_CLIPS)]
    models = build_models(G, Path(args.grid_dir), args.max_val_loss, model_file=args.model_file)
    print(f"{len(models)} models x {len(clips)} clips")
    return study(G, clips, models, Path(args.out), skip_calibration=args.skip_calibration)


if __name__ == "__main__":
    main()
