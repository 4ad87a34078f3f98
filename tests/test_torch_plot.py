"""The port's plotting module (``ssar_tpu_torch/utils/plot.py``) against the
JAX package's: the autocorrelation and the feature-group sums equal (float64
numpy on both sides, bit for bit), and every plot writes a non-empty PNG."""
import importlib

import numpy as np
import pytest

from ssar_tpu_torch.utils import plot as t_plot

j_plot = importlib.import_module("ssar_tpu.utils.plot")

pytest.importorskip("matplotlib")


def test_autocorrelation_and_group_sums_match_jax():
    x = np.random.RandomState(0).randn(40, 59).astype(np.float32)
    assert np.array_equal(t_plot.autocorrelation(x), j_plot.autocorrelation(x))
    assert np.array_equal(t_plot.autocorrelation(x.reshape(40, 59, 1)), j_plot.autocorrelation(x.reshape(40, 59, 1)))
    for normalize in (False, True):
        for sections in (t_plot.FEATURE_GROUP_SECTIONS, (3, 100), (20, 12)):
            got = t_plot.feature_group_autocorrelation_sum(x, sections, normalize)
            want = j_plot.feature_group_autocorrelation_sum(x, sections, normalize)
            assert got.shape == (40, 40) and np.array_equal(got, want)


def _png(path) -> bool:
    return path.exists() and path.stat().st_size > 0 and path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_every_plot_writes_a_png(tmp_path):
    rng = np.random.RandomState(1)
    records = [{"clip": f"c{i}", "correlation": float(rng.rand()), "chromagram|rgb_hist": float(rng.rand()),
                "onsets|absdiff": float(rng.rand())} for i in range(3)]
    t_plot.correlation_heatmap(records, str(tmp_path / "heat.png"))
    t_plot.autocorrelation_grid({"a": rng.randn(24, 5), "b": rng.randn(24, 3, 2)}, str(tmp_path / "grid.png"))
    facs, iacs = t_plot.aggregated_autocorrelations([rng.randn(16, 59) for _ in range(3)], str(tmp_path / "agg.png"))
    want_f, want_i = j_plot.aggregated_autocorrelations([np.random.RandomState(1 + i).randn(16, 59) for i in range(1)],
                                                        str(tmp_path / "jax_agg.png"))
    got_f, got_i = t_plot.aggregated_autocorrelations([np.random.RandomState(1 + i).randn(16, 59) for i in range(1)],
                                                      str(tmp_path / "port_agg.png"))
    assert np.array_equal(got_f, want_f) and np.array_equal(got_i, want_i) and facs.shape == iacs.shape == (3, 16, 16)
    rows = [{"config": c, "iterations": it, "val_latent_rv2": float(rng.rand()), "val_latent_rv2_std": 0.1}
            for c in ("a", "b") for it in (1, 2, 3)]
    t_plot.training_curves_plot(rows, str(tmp_path / "curves.png"))
    t_plot.envelope_report(rng.randn(32, 6).astype(np.float32), rng.randn(32, 3).astype(np.float32),
                           str(tmp_path / "env.png"))
    plt = t_plot._plt()
    fig, ax = plt.subplots()
    handles = t_plot.grouped_bar_plot(ax, {"x": [1, 2, 3], "y": [2, 1, 0.5]}, xlabels=["p", "q", "r"])
    fig.savefig(tmp_path / "bars.png")
    plt.close(fig)
    assert len(handles) == 2
    for name in ("heat", "grid", "agg_full", "agg_grouped", "curves", "env", "bars"):
        assert _png(tmp_path / f"{name}.png"), name
