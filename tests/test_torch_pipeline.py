"""The paper's pipeline entry points on the port (``ssar_tpu_torch/experiments.py``,
``ssar_tpu_torch/scripts/``) against the JAX package's (``experiments.py``,
``scripts/``), small, on the CPU.

Tolerances:
- ``synth_track``: bit-equal (the same numpy arithmetic);
- ``make_targets`` on one set of music information (``inject_mir``), JAX's
  draws (``jax_keys``) and one palette: latents and each noise level within
  1e-4 of the largest value (up to 20 subpatches applied one on another, as
  in tests/test_torch_patch.py);
- ``GRIDS`` and every cell's trainer argv: equal;
- the absolute OOD's image batches on the committed calibration G: within
  1e-4 (images in [0, 1]), the synthesis in float32 on both sides (XLA and
  torch round bf16 at different points, 1e-3 relative: ROADMAP, "bf16
  synthesis"); the real batches as the script makes them;
- the calibration G's npz: the keys and shapes the JAX CLI writes, float16.
The tiny grid run trains one real cell on the CPU at hidden 32 (the width
``build_models`` reads), 2 layers, 2 steps of batch 8 on the trainer's
synthetic windows of 2 s, its Frechet context distance and checkpoint
renders off through the trainer's parser defaults (40 s and 15 s of CPU;
``chip_smoke.py`` phase 28 runs both).  The OOD's generator batch is held at
2 of the 16 draws (a 256 px float32 synthesis takes ~1 s an image here).
"""
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch import experiments as t_exp
from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.gan.wrapper import StyleGAN2
from ssar_tpu_torch.generate import keys as t_keys
from ssar_tpu_torch.generate import patch as t_patch
from ssar_tpu_torch.scripts import make_record_dataset as t_mrd
from ssar_tpu_torch.scripts import ood_absolute as t_ood
from ssar_tpu_torch.scripts import run_study as t_study
from ssar_tpu_torch.scripts import train_calibration_g as t_calg
from ssar_tpu_torch.train import palette_g as t_pg
from torch_parity import inject_mir, jax_keys, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CALIBRATION = ROOT / "docs" / "study"
js = importlib.import_module("ssar_tpu.gan.stylegan2")
j_convert = importlib.import_module("ssar_tpu.gan.convert")
j_pg = importlib.import_module("ssar_tpu.train.palette_g")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


j_exp = _load("jax_experiments", ROOT / "experiments.py")
j_mrd = _load("jax_make_record_dataset", ROOT / "scripts" / "make_record_dataset.py")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ the corpus --
@pytest.mark.parametrize("seed", [1000, 2001])
def test_synth_track_is_bit_equal(seed):
    got, want = t_mrd.synth_track(seed, seconds=2), j_mrd.synth_track(seed, seconds=2)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_make_targets_matches_jax(monkeypatch):
    """Layers wider than 32 px, which make_targets never reads, are cut to
    32 px in both packages (their 1024 px banks took JAX 60 s on the CPU);
    the draws of the layers it reads do not depend on them."""
    seconds = 2
    T = seconds * t_mrd.FPS
    inject_mir(monkeypatch, T, seed=3)
    jax_keys(monkeypatch)
    monkeypatch.setattr(t_keys, "choice", lambda key, n, p: int(jax.random.choice(
        key, n, p=jnp.asarray(np.asarray(p, np.float32)))))
    small = [min(s, 32) for s in t_patch.NOISE_SIZES]
    monkeypatch.setattr(t_patch, "NOISE_SIZES", small)
    monkeypatch.setattr(importlib.import_module("ssar_tpu.generate.patch"), "NOISE_SIZES", small)
    audio = t_mrd.synth_track(1000, seconds=seconds)
    palette = (0.5 * np.random.RandomState(0).randn(24, 18, 512)).astype(np.float32)
    # seed 1004 draws 7 latent and 15 noise subpatches, the quickest of seeds 1000-1011 for JAX to compile
    want_lat, want_noise = j_mrd.make_targets(audio, seed=1004, palette=jnp.asarray(palette))
    got_lat, got_noise = t_mrd.make_targets(audio, seed=1004, palette=torch.as_tensor(palette))
    assert got_lat.shape == (T, 18, 512) and got_lat.dtype == np.float32
    assert _rel_err(got_lat, want_lat) <= 1e-4
    assert [n.shape for n in got_noise] == [(T, s, s) for s in (4, 8, 16, 32)]
    for g, w in zip(got_noise, want_noise):
        assert _rel_err(g, w) <= 1e-4


# -------------------------------------------------------------- the grid --
def test_grids_and_every_cells_argv_match_jax(monkeypatch, tmp_path):
    assert t_exp.GRIDS == j_exp.GRIDS
    got, want = [], []

    def recorder(log):
        def main(argv):
            log.append(list(argv))
            return tmp_path / f"run{len(log)}", 1.0
        return main

    monkeypatch.setattr(importlib.import_module("ssar_tpu.train.train"), "main", recorder(want))
    monkeypatch.setattr(importlib.import_module("ssar_tpu_torch.train.train"), "main", recorder(got))
    for name in j_exp.GRIDS:
        n = len(want)
        j_rows = j_exp.run_grid(name, str(tmp_path / "runs"))
        t_rows = t_exp.run_grid(name, str(tmp_path / "runs"), device="cpu")
        assert len(want) - n == len(j_rows) == len(t_rows) > 0
        for j_row, t_row in zip(j_rows, t_rows):
            assert set(t_row) == set(j_row) and t_row["val_loss"] == j_row["val_loss"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w + ["--device", "cpu"]


TINY = {"backbone": ["gru"], "decoder": ["fixed"], "loss": ["supervised"], "hidden_size": [32],
        "num_layers": [2], "n_examples": [16], "lr": [1e-3], "batch_size": [8],
        "_extra": {"render_size": 32, "duration": 2}}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One real cell of a tiny grid on the CPU, under the name `record`
    (the name scripts/collect_grid.py reads)."""
    from ssar_tpu_torch.train import train as t_train

    build_parser = t_train.build_parser

    def parser():
        p = build_parser()
        p.set_defaults(fcd=False, render_at_ckpt=False)
        return p

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_train, "build_parser", parser)
            runs = tmp_path_factory.mktemp("runs")
            rows = t_exp.run_grid("record", str(runs), device="cpu", grid=TINY)
    finally:
        torch.set_num_threads(n)
    return runs, rows


def test_tiny_grid_run_has_the_jax_runners_row_and_collect_grid_reads_it(tiny_run, tmp_path):
    runs, rows = tiny_run
    assert len(rows) == 1 and "error" not in rows[0], rows
    cfg = {k: v[0] for k, v in TINY.items() if k != "_extra"}
    # the JAX runner's row: the cell and its tagged extra, the loss, the wall time, the run and the
    # trainer's final metrics
    assert set(rows[0]) == {*cfg, "duration", "val_loss", "seconds", "log_dir", "val_loss_median"}
    assert {k: rows[0][k] for k in cfg} == cfg and np.isfinite(rows[0]["val_loss"])
    assert json.loads((runs / "record_results.json").read_text()) == rows
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "collect_grid.py"), "--runs", str(runs),
                          "--out", str(tmp_path)], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "GRID.md").exists() and (tmp_path / "grid" / "loss_curves.png").exists()
    assert (tmp_path / "grid" / "record_results.csv").exists()


def test_build_models_loads_the_run_and_refuses_a_collapsed_one(tiny_run):
    runs, rows = tiny_run
    G = StyleGAN2(output_size=(32, 32), config=ts.StyleGAN2Config(resolution=32, max_channels=32), device="cpu")
    models = t_study.build_models(G, runs, max_val_loss=2 * rows[0]["val_loss"])
    assert sorted(models) == ["gru_supervised", "lucid_baseline", "lucid_low_amp", "random_patch", "ssopt",
                              "ssopt_amp"]
    assert models["ssopt"].n_steps == t_study.SSOPT_STEPS == 512 and models["ssopt_amp"].lambda_amplitude == 100.0
    assert next(models["gru_supervised"].model.parameters()).device.type == "cpu"
    with pytest.raises(SystemExit, match="REFUSING"):
        t_study.build_models(G, runs, max_val_loss=0.5 * rows[0]["val_loss"])


# ------------------------------------------------------- calibration, OOD --
def test_ood_batches_match_the_jax_scripts(monkeypatch):
    jax_keys(monkeypatch)
    jc = js.StyleGAN2Config(resolution=256, max_channels=128)
    tc = ts.StyleGAN2Config(resolution=256, max_channels=128)
    j_params = j_convert.load_npz(str(CALIBRATION / "calibration_g.npz"))
    t_params = importlib.import_module("ssar_tpu_torch.gan.convert").load_npz(str(CALIBRATION / "calibration_g.npz"))
    # the script's draws: PRNGKey(11) split into (real, fake), batch i from fold_in(key, i)
    k_real, k_fake = jax.random.split(jax.random.PRNGKey(11))
    z_real = jax.random.normal(jax.random.fold_in(k_real, 0), (16, 512))
    z_fake = jax.random.normal(jax.random.fold_in(k_fake, 0), (16, 512))
    t_real_key, t_fake_key = t_keys.split(t_keys.PRNGKey(11))
    assert np.array_equal(t_ood.z_draws(t_real_key, 1, batch_size=16)[0].numpy(), np.asarray(z_real))
    assert np.array_equal(t_ood.z_draws(t_fake_key, 1, batch_size=16)[0].numpy(), np.asarray(z_fake))

    P = j_pg.target_basis(512)

    @jax.jit   # as the script jits its batches
    def real_batch(z):
        return jnp.clip((j_pg.procedural_targets(js.mapping(j_params, z, jc), P, 256) + 1) / 2, 0, 1)

    @jax.jit
    def fake_batch(z):
        w = js.mapping(j_params, z, jc)
        return jnp.clip((js.synthesis(j_params, js.w_to_wplus(w, jc), None, jc, dtype=jnp.float32) + 1) / 2, 0, 1)

    got_real = t_ood.image_batch(t_params, tc, torch.tensor(np.asarray(z_real)), P=t_pg.target_basis(512))
    got_fake = t_ood.image_batch(t_params, tc, torch.tensor(np.asarray(z_fake[:2])), dtype=torch.float32)
    assert got_real.shape == (16, 256, 256, 3) and got_fake.shape == (2, 256, 256, 3)
    assert float(np.abs(got_real.numpy() - np.asarray(real_batch(z_real))).max()) <= 1e-4
    assert float(np.abs(got_fake.numpy() - np.asarray(fake_batch(z_fake[:2]))).max()) <= 1e-4


def _shapes(tree) -> dict:
    leaves, _ = jax.tree.flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): tuple(np.shape(leaf))
            for kp, leaf in leaves}


def test_calibration_npz_reads_in_the_jax_package(tmp_path):
    record = t_calg.main(["--out", str(tmp_path), "--resolution", "16", "--max_channels", "16", "--n_steps", "1",
                          "--batch_size", "2", "--device", "cpu"])
    assert len(record["mse"]) == 1 and np.isfinite(record["target_alignment"])
    assert json.loads((tmp_path / "calibration_g_curve.json").read_text()) == record
    config = js.StyleGAN2Config(resolution=16, max_channels=16)
    want_g = _shapes(jax.eval_shape(lambda k: js.init_generator(k, config), jax.random.PRNGKey(0)))
    D = importlib.import_module("ssar_tpu.gan.discriminator").Discriminator(resolution=16, channel_multiplier=1)
    want_d = _shapes(jax.eval_shape(lambda k: D.init(k, jnp.zeros((1, 16, 16, 3))), jax.random.PRNGKey(0)))
    for name, want in (("calibration_g.npz", want_g), ("calibration_d.npz", want_d)):
        with np.load(tmp_path / name) as data:
            assert {data[k].dtype for k in data.files} == {np.dtype(np.float16)}
        assert _shapes(j_convert.load_npz(str(tmp_path / name))) == want, name
