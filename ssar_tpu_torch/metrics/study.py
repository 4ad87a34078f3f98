"""AV feature study: which audio features predict which video features?

Counterpart of ``ssar_tpu/metrics/study.py``: for a corpus of (audio, video)
pairs, optionally in named groups, extract the 9 audio x 12 video feature
matrices of the comparison harness, score every pair under a panel of
correlation measures, and emit tidy records plus the report: per-clip
extrema, concat-correlation bars, per-measure group bars and per-group score
histograms.

Record schema (one row per scored pair):
    {"group", "clip", "measure", "audio_feature", "video_feature", "value"}
Scores of the channel-concatenated features (all 9 audio matrices | all 12
video matrices) have audio_feature = video_feature = "concat".

The panel defaults to {procrustes, pwcca, rv2, smi, svcca}; ``measures``
takes any name of ``metrics.correlation.CORRELATION_FNS``.  The features run
on `device` (the CUDA device unless given); the plots need matplotlib and the
CSV pandas (skipped without it).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device
from .comparison import AFNS, VFN_NAMES, VFNS
from .correlation import CORRELATION_FNS

STUDY_MEASURES = ("procrustes", "pwcca", "rv2", "smi", "svcca")


def _flatten(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(f.shape[0], -1)


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=torch.float32).to(device)


@torch.no_grad()
def extract_av_features(audio, sr: int, video, cache_stem: str | None = None,
                        device: str | torch.device | None = None):
    """The study's 9 audio + 12 video feature dicts of one clip, trimmed to a
    common length, on `device`; cached as ``<cache_stem>_afeats.npz`` /
    ``_vfeats.npz`` when ``cache_stem`` is given."""
    device = resolve_device(device)
    if cache_stem is not None:
        ap, vp = Path(f"{cache_stem}_afeats.npz"), Path(f"{cache_stem}_vfeats.npz")
        if ap.exists() and vp.exists():
            with np.load(ap) as arr:
                afeats = {k: torch.as_tensor(arr[k], device=device) for k in arr.files}
            with np.load(vp) as arr:
                vfeats = {k: torch.as_tensor(arr[k], device=device) for k in arr.files}
            return afeats, vfeats
    audio, video = _tensor(audio, device), _tensor(video, device)
    afeats = {fn.__name__: _flatten(fn(audio, int(sr))) for fn in AFNS}
    vfeats = {vn: _flatten(fn(video)) for vn, fn in zip(VFN_NAMES, VFNS)}
    T = min(min(a.shape[0] for a in afeats.values()), min(v.shape[0] for v in vfeats.values()))
    afeats = {k: v[:T] for k, v in afeats.items()}
    vfeats = {k: v[:T] for k, v in vfeats.items()}
    if cache_stem is not None:
        Path(cache_stem).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(f"{cache_stem}_afeats.npz", **{k: v.cpu().numpy() for k, v in afeats.items()})
        np.savez_compressed(f"{cache_stem}_vfeats.npz", **{k: v.cpu().numpy() for k, v in vfeats.items()})
    return afeats, vfeats


def _smoothness(f: torch.Tensor, absolute: bool) -> torch.Tensor:
    d = f.diff(dim=0)
    return (d.abs() / (f.abs().amax(0) + 1e-8)).max() if absolute else (d / (f.amax(0) + 1e-8)).max()


def _variation(f: torch.Tensor) -> torch.Tensor:
    return f.std(0, unbiased=False).mean() / (torch.linalg.vector_norm(f) + 1e-8)


@torch.no_grad()
def audiovisual_correlation(afeats: dict, vfeats: dict, cname: str, correlation_fn, quadratic: bool = False,
                            variation_normalized: bool = False, mean_diff_normalized: bool = False):
    """quadratic=True: one score per (audio feature, video feature) pair,
    {(aname, vname, cname): value}; quadratic=False: one score of the
    channel-concatenated matrices.  The optional normalisers scale scores by
    the signals' smoothness / variation."""
    if quadratic:
        names, scores = [], []
        for aname, af in afeats.items():
            for vname, vf in vfeats.items():
                cor = correlation_fn(af, vf)
                if mean_diff_normalized:
                    cor = cor * (_smoothness(af, True) + _smoothness(vf, True))
                if variation_normalized:
                    cor = cor * (_variation(af) + _variation(vf))
                names.append((aname, vname, cname))
                scores.append(torch.as_tensor(cor, dtype=torch.float32))
        return dict(zip(names, torch.stack(scores).tolist())) if scores else {}
    af = torch.cat(list(afeats.values()), dim=1)
    vf = torch.cat(list(vfeats.values()), dim=1)
    res = correlation_fn(af, vf)
    if mean_diff_normalized:
        res = res * (_smoothness(af, False) + _smoothness(vf, False))
    if variation_normalized:
        res = res * (_variation(af) + _variation(vf))
    return float(res)


def av_feature_study(pairs, measures=STUDY_MEASURES, out_dir: str | None = None,
                     groups: dict | None = None, cache_dir: str | None = None,
                     device: str | torch.device | None = None):
    """Score every (audio feature x video feature) pair per clip.

    pairs: [(name, audio, sr, video (T, C, H, W) in [0, 1])].
    groups: optional {clip_name: group_name}; defaults to one group "all".
    Returns tidy records (schema above, incl. "concat" rows); writes
    ``av_study.csv`` and the report when ``out_dir`` is given.
    """
    fns = {m: CORRELATION_FNS[m] for m in measures}
    records = []
    for name, audio, sr, video in pairs:
        stem = str(Path(cache_dir) / name) if cache_dir else None
        afeats, vfeats = extract_av_features(audio, sr, video, cache_stem=stem, device=device)
        group = (groups or {}).get(name, "all")
        for m, fn in fns.items():
            quad = audiovisual_correlation(afeats, vfeats, m, fn, quadratic=True)
            for (an, vn, _), val in quad.items():
                records.append({"group": group, "clip": name, "measure": m,
                                "audio_feature": an, "video_feature": vn, "value": val})
            records.append({"group": group, "clip": name, "measure": m,
                            "audio_feature": "concat", "video_feature": "concat",
                            "value": audiovisual_correlation(afeats, vfeats, m, fn)})
    if out_dir is not None:
        write_study_report(records, out_dir, measures=measures)
    return records


# ---------------------------------------------------------------------------
# the report (experiment.py:263-386)


def group_stats(records: list[dict]):
    """Median/std per (group, measure, audio_feature, video_feature) —
    the reference's groupby("group").agg(["median", "std"])
    (experiment.py:276-303). Returns tidy stat dicts."""
    cells = {}
    for r in records:
        key = (r["group"], r["measure"], r["audio_feature"], r["video_feature"])
        cells.setdefault(key, []).append(r["value"])
    return [{"group": g, "measure": m, "audio_feature": a, "video_feature": v,
             "median": float(np.nanmedian(vals)), "std": float(np.nanstd(vals))}
            for (g, m, a, v), vals in cells.items()]


def extrema(records: list[dict], n: int = 5, measure: str = "procrustes") -> dict:
    """Best/worst clips per group by concat score (experiment.py:263-274)."""
    out = {}
    per_group = {}
    for r in records:
        if r["measure"] == measure and r["audio_feature"] == "concat" and np.isfinite(r["value"]):
            per_group.setdefault(r["group"], []).append((r["value"], r["clip"]))
    for g, vals in per_group.items():
        vals.sort(reverse=True)
        out[g] = {"best": vals[:n], "worst": vals[-n:][::-1]}
    return out


MEASURE_TITLES = {
    "procrustes": "Orthogonal Procrustes",
    "rv2": "Adjusted RV Coefficient",
    "smi": "Matrix Similarity Index",
    "pwcca": "Projection-weighted CCA",
    "svcca": "SVCCA",
}


def concatbar(stats: list[dict], out_file: str, measure: str = "procrustes"):
    """Median concat correlation per group, one bar each
    (experiment.py:305-317)."""
    from ..utils.plot import _plt

    plt = _plt()
    rows = [s for s in stats if s["measure"] == measure and s["audio_feature"] == "concat"]
    groups = [s["group"] for s in rows]
    fig, ax = plt.subplots(figsize=(max(4, len(groups) * 1.2), 4))
    ax.bar(groups, [s["median"] for s in rows], yerr=[s["std"] for s in rows],
           color=plt.cm.tab10(np.arange(len(groups)) % 10))
    ax.set_xlabel("Group")
    ax.set_ylabel(f"{MEASURE_TITLES.get(measure, measure)} (concat)")
    ax.tick_params(axis="x", rotation=10)
    fig.tight_layout()
    fig.savefig(out_file)
    plt.close(fig)


def groupbars(stats: list[dict], out_file: str, measures=STUDY_MEASURES,
              audio_filter: str | None = None):
    """Per-measure panel of group bars over the quadratic scores; optional
    restriction to one audio feature (the reference's full/chroma/onsets
    variants, experiment.py:323-347)."""
    from ..utils.plot import _plt

    plt = _plt()
    measures = [m for m in measures if m != "svcca"]
    ncols = 2
    nrows = (len(measures) + 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(16, 4.5 * nrows), sharex=True, squeeze=False)
    for c, m in enumerate(measures):
        ax = axes.flatten()[c]
        rows = [s for s in stats
                if s["measure"] == m and s["audio_feature"] != "concat"
                and (audio_filter is None or s["audio_feature"] == audio_filter)]
        per_group = {}
        for s in rows:
            per_group.setdefault(s["group"], []).append(s["median"])
        groups = list(per_group)
        ax.bar(groups, [float(np.nanmedian(v)) for v in per_group.values()],
               yerr=[float(np.nanstd(v)) for v in per_group.values()],
               color=plt.cm.tab10(np.arange(len(groups)) % 10))
        ax.set_title(MEASURE_TITLES.get(m, m))
        ax.tick_params(axis="x", rotation=10)
    for c in range(len(measures), nrows * ncols):
        axes.flatten()[c].axis("off")
    fig.tight_layout()
    fig.savefig(out_file)
    plt.close(fig)


def grouphists(records: list[dict], out_file: str, measures=STUDY_MEASURES,
               mode: str = "quadratic", bins: int = 100):
    """Histogram grid: rows = groups, cols = measures, of per-clip scores;
    mode selects quadratic pairs / concat / one audio feature
    (experiment.py:349-386)."""
    from ..utils.plot import _plt

    plt = _plt()
    measures = [m for m in measures if m != "svcca"]

    def keep(r):
        if mode == "quadratic":
            return r["audio_feature"] != "concat"
        if mode == "concat":
            return r["audio_feature"] == "concat"
        return r["audio_feature"] == mode

    rows = [r for r in records if keep(r) and np.isfinite(r["value"])]
    groups = list(dict.fromkeys(r["group"] for r in rows))
    vals_all = [r["value"] for r in rows] or [0.0]
    lo, hi = float(np.min(vals_all)), float(np.max(vals_all))
    rng = (lo, hi if hi > lo else lo + 1.0)
    fig, axes = plt.subplots(len(groups), len(measures),
                             figsize=(4 * len(measures), 2.2 * len(groups)),
                             sharex=True, squeeze=False)
    for g, group in enumerate(groups):
        color = plt.cm.tab10(g % 10)
        for c, m in enumerate(measures):
            data = [r["value"] for r in rows if r["group"] == group and r["measure"] == m]
            ax = axes[g, c]
            if data:
                y, _, _ = ax.hist(data, bins=bins, range=rng, color=color, density=True)
                ax.vlines(float(np.median(data)), 0, y.max() or 1, ls="--", color=color)
            ax.set_yticklabels([])
            if g == len(groups) - 1:
                ax.set_xlabel(MEASURE_TITLES.get(m, m))
            if c == 0:
                ax.set_ylabel(group)
    fig.tight_layout()
    fig.savefig(out_file)
    plt.close(fig)


def write_study_report(records: list[dict], out_dir: str, measures=STUDY_MEASURES):
    """CSV + the full figure battery + extrema text for one study."""
    from ..utils.plot import correlation_heatmap

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        pd.DataFrame(records).to_csv(out / "av_study.csv")
    stats = group_stats(records)
    for m in measures:
        recs_m = [{"clip": r["clip"], f"{r['audio_feature']}|{r['video_feature']}": r["value"]}
                  for r in records if r["measure"] == m and r["audio_feature"] != "concat"]
        if recs_m:
            correlation_heatmap(recs_m, str(out / f"av_study_{m}.png"))
    concatbar(stats, str(out / "barplot_concat_corr.png"))
    groupbars(stats, str(out / "group_corr_bars_full.png"), measures)
    for af in ("chromagram", "onsets"):
        if any(s["audio_feature"] == af for s in stats):
            groupbars(stats, str(out / f"group_corr_bars_{af}.png"), measures, audio_filter=af)
    for mode in ("quadratic", "concat"):
        grouphists(records, str(out / f"group_corr_hists_{mode}.png"), measures, mode=mode)
    ex = extrema(records, measure=measures[0])
    lines = []
    for g, d in ex.items():
        lines.append(f"# {g}")
        lines += [f"best  {v:.4f}  {c}" for v, c in d["best"]]
        lines += [f"worst {v:.4f}  {c}" for v, c in d["worst"]]
    (out / "extrema.txt").write_text("\n".join(lines) + "\n")
    return stats


@torch.no_grad()
def feature_visualizations(audio, sr: int, video, out_dir: str, device: str | torch.device | None = None):
    """Every study feature as an image (matrices, inferno) or a line plot
    (one channel), time on the x axis; returns the PNG names."""
    from ..utils.plot import _plt

    plt = _plt()
    device = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    audio, video = _tensor(audio, device), _tensor(video, device)
    feats = {fn.__name__: _flatten(fn(audio, int(sr))).cpu().numpy() for fn in AFNS}
    feats.update({vn: _flatten(fn(video)).cpu().numpy() for vn, fn in zip(VFN_NAMES, VFNS)})
    for name, feat in feats.items():
        fig = plt.figure(figsize=(6.5, 1.6))
        if feat.shape[-1] == 1:
            plt.plot(feat[:, 0], linewidth=0.5, color="black")
            plt.xlim(0, len(feat))
        else:
            lo, hi = feat.min(), feat.max()
            plt.imshow((feat.T - lo) / (hi - lo + 1e-8), cmap="inferno", aspect="auto", origin="lower")
        plt.axis("off")
        fig.savefig(out / f"{name}.png", bbox_inches="tight", pad_inches=0, dpi=100)
        plt.close(fig)
    return sorted(p.name for p in out.glob("*.png"))
