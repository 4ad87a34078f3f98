"""Plotting: AV-correlation heatmaps, autocorrelation grids, report figures.

The port's copy of ``ssar_tpu/utils/plot.py``: numpy in, matplotlib (Agg)
files out.  Per-feature-pair correlation heatmaps, time-autocorrelation
grids, grouped bar plots, per-feature-group autocorrelation sums and their
image grids, metric-over-training curve panels, and the training-time
envelope report.  matplotlib is imported inside each plotting function, so
the module imports where matplotlib is missing.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def correlation_heatmap(records: list[dict], out_file: str, value_key: str = "correlation"):
    """Per (audio-feature x video-feature) correlation heatmap from
    compare_models records (plot.py:127-215)."""
    plt = _plt()
    pair_keys = sorted({k for r in records for k in r if "|" in k})
    a_names = sorted({k.split("|")[0] for k in pair_keys})
    v_names = sorted({k.split("|")[1] for k in pair_keys})
    grid = np.full((len(a_names), len(v_names)), np.nan)
    for i, a in enumerate(a_names):
        for j, v in enumerate(v_names):
            vals = [r[f"{a}|{v}"] for r in records if f"{a}|{v}" in r]
            if vals:
                grid[i, j] = np.mean(vals)
    fig, ax = plt.subplots(figsize=(2 + len(v_names), 2 + len(a_names) * 0.5))
    im = ax.imshow(grid, cmap="inferno")
    ax.set_xticks(range(len(v_names)), v_names, rotation=90)
    ax.set_yticks(range(len(a_names)), a_names)
    fig.colorbar(im)
    fig.tight_layout()
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def autocorrelation(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.mean(0)
    x = x / (x.std(0) + 1e-8)
    x = x.reshape(len(x), -1)
    return x @ x.T


def autocorrelation_grid(named_signals: dict, out_file: str, cmap: str = "inferno"):
    """Grid of time-autocorrelation matrices, one per named signal
    (plot.py:342-412, train.py:118-146)."""
    plt = _plt()
    n = len(named_signals)
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows), squeeze=False)
    for ax in axes.flatten():
        ax.axis("off")
    for ax, (name, sig) in zip(axes.flatten(), named_signals.items()):
        ac = autocorrelation(np.asarray(sig))
        ac = ac - ac.min()
        ac = ac / (ac.max() + 1e-8)
        ax.imshow(ac, cmap=cmap)
        ax.set_title(name, fontsize=8)
    fig.tight_layout()
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def grouped_bar_plot(ax, data: dict, xlabels=None, colors=None,
                     total_width: float = 0.8, single_width: float = 1.0,
                     legend: bool = True):
    """Multiple bars per data point (ssar/plot.py:215-283 semantics).

    ``data`` maps series name -> list of values; each x position gets one
    bar per series, the group spanning ``total_width`` of the slot.
    """
    plt = _plt()
    if colors is None:
        colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    n_series = len(data)
    bar_width = total_width / max(n_series, 1)
    handles = []
    for i, (name, values) in enumerate(data.items()):
        x_offset = (i - n_series / 2) * bar_width + bar_width / 2
        xs = np.arange(len(values)) + x_offset
        bars = ax.bar(xs, values, width=bar_width * single_width,
                      color=colors[i % len(colors)])
        handles.append(bars[0])
    if xlabels is not None:
        ax.set_xticks(range(len(xlabels)))
        ax.set_xticklabels(list(xlabels), rotation=40, ha="right")
    if legend:
        ax.legend(handles, data.keys())
    return handles


# the canonical 59-dim stack's feature-group boundaries: mfcc(20), chroma(12),
# tonnetz(6), contrast(7), then the 14 single-channel envelopes
FEATURE_GROUP_SECTIONS = (20, 12, 6, 7, None)


def feature_group_autocorrelation_sum(features: np.ndarray,
                                      sections=FEATURE_GROUP_SECTIONS,
                                      normalize: bool = False) -> np.ndarray:
    """Sum of per-feature-group time-autocorrelation Grams (T, T)
    (ssar/plot.py:414-421): each contiguous section of the feature axis
    contributes its own ``X Xᵀ`` so large groups don't drown the envelopes.
    ``None`` as the last section means "everything remaining".  With
    ``normalize``, each section is scaled into [0, 1] by its own GROUP-wide
    min/max before the Gram (ssar/plot.py:383-385) — per-column scaling would
    weight channels within a group differently than the reference."""
    x = np.asarray(features, np.float64)
    T = len(x)
    acs = np.zeros((T, T))
    i = 0
    for section in sections:
        j = x.shape[1] if section is None else min(i + section, x.shape[1])
        if j > i:
            block = x[:, i:j]
            if normalize:
                block = block - block.min()
                block = block / (block.max() + 1e-8)
            acs += block @ block.T
        i = j
        if i >= x.shape[1]:
            break
    return acs


def aggregated_autocorrelations(feature_mats: list[np.ndarray], out_file: str,
                                sections=FEATURE_GROUP_SECTIONS, nrow: int = 12):
    """Tile normalized full + per-group-summed autocorrelation matrices over
    many tracks into two image grids (ssar/plot.py:368-394).  Returns the
    (facs, iacs) stacks; ``out_file`` gets ``_full``/``_grouped`` suffixes.
    """
    plt = _plt()
    facs, iacs = [], []
    for feats in feature_mats:
        x = np.asarray(feats, np.float64).reshape(len(feats), -1)
        fac = x @ x.T
        fac = fac - fac.min()
        fac = fac / (fac.max() + 1e-8)
        facs.append(fac)
        iac = feature_group_autocorrelation_sum(x, sections, normalize=True)
        iac = iac - iac.min()
        iac = iac / (iac.max() + 1e-8)
        iacs.append(iac)
    out = Path(out_file)
    out.parent.mkdir(parents=True, exist_ok=True)
    for name, stack in (("full", facs), ("grouped", iacs)):
        n = len(stack)
        cols = min(nrow, n)
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows), squeeze=False)
        for ax in axes.flatten():
            ax.axis("off")
        for ax, ac in zip(axes.flatten(), stack):
            ax.imshow(ac, cmap="inferno")
        fig.tight_layout()
        fig.savefig(out.with_name(f"{out.stem}_{name}{out.suffix or '.png'}"))
        plt.close(fig)
    return np.stack(facs), np.stack(iacs)


def training_curves_plot(records: list[dict], out_file: str,
                         outputs=("latent", "noise", "envelope"),
                         splits=("train", "val", "test"), metric: str = "rv2"):
    """Metric-over-iterations curve grid with ±σ bands, one panel per
    (output, split), one line per run configuration (ssar/plot.py:43-79).

    ``records`` rows carry {"config", "iterations", "<split>_<output>_<metric>"
    [, "..._std"]}; rows missing a panel's key are skipped.
    """
    plt = _plt()
    configs = sorted({r["config"] for r in records})
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    fig, ax = plt.subplots(len(outputs), len(splits),
                           figsize=(6 * len(splits), 4 * len(outputs)), squeeze=False)
    for i, output in enumerate(outputs):
        for j, split in enumerate(splits):
            key = f"{split}_{output}_{metric}"
            plotted = False
            for k, config in enumerate(configs):
                rows = sorted((r for r in records if r["config"] == config and key in r),
                              key=lambda r: r["iterations"])
                if not rows:
                    continue
                plotted = True
                x = np.array([r["iterations"] for r in rows])
                y = np.array([r[key] for r in rows])
                ax[i, j].plot(x, y, color=colors[k % len(colors)], label=config)
                if f"{key}_std" in rows[0]:
                    err = np.array([r.get(f"{key}_std", 0.0) for r in rows])
                    ax[i, j].fill_between(x, y - err, y + err, alpha=0.25,
                                          color=colors[k % len(colors)])
            ax[i, j].set_title(f"{split} {output}")
            if plotted:  # empty panels would warn 'no artists with labels'
                ax[i, j].legend()
            ax[-1, j].set_xlabel("iterations")
        ax[i, 0].set_ylabel(f"{metric} loss")
    fig.tight_layout()
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def envelope_report(inputs: np.ndarray, envelopes: np.ndarray, out_file: str):
    """Training-time diagnostic: the input envelopes most correlated with the
    generated ones (by 1 - orthogonal procrustes distance) beside the
    generated envelopes, as outer-product images.  Inputs (T, F) and
    envelopes (T, E) are host arrays; the distances run on the CPU."""
    import torch

    from ..train.losses import orthogonal_procrustes_distance

    plt = _plt()
    n_env = envelopes.shape[-1]
    env = torch.as_tensor(np.asarray(envelopes, np.float32))
    inp = torch.as_tensor(np.asarray(inputs, np.float32))
    corrs = np.array([1 - float(orthogonal_procrustes_distance(inp[:, i : i + 1], env))
                      for i in range(inputs.shape[-1])])
    top = np.argsort(corrs)[::-1][:n_env]
    fig, ax = plt.subplots(n_env, 2, figsize=(8, 2 * n_env), squeeze=False)
    for e in range(n_env):
        ienv = inputs[:, top[e]]
        ax[e, 0].imshow(np.outer(ienv, ienv), cmap="inferno")
        genv = envelopes[:, e]
        ax[e, 1].imshow(np.outer(genv, genv), cmap="inferno")
        ax[e, 0].axis("off")
        ax[e, 1].axis("off")
    ax[0, 0].set_title("most correlated inputs")
    ax[0, 1].set_title("generated envelopes")
    fig.tight_layout()
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file
