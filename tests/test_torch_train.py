"""The port's training path vs the JAX package's, on the CPU.

Losses, one train step per loss mode (JAX's own ``make_train_step`` with an
optimizer that hands the gradients back as its state), the clipped Adam
against optax, the data pipeline, the config overlay and a resumed run.
Tolerances: losses at rtol 1e-4 (float32 eigvalsh and sums of another
library); gradients at rtol 1e-3 of each leaf's largest magnitude (the
eigenvalue gradients and the fixed decoder's env / env.sum magnify
round-off); the optimizer at rtol 1e-6 on the parameters (the same float32
formula, fused differently); numpy data pipelines exactly.  Windows are
T = 96 frames: below 60 the selfsupervised 59 x 59 Gram is rank-deficient and
its zero eigenvalues turn round-off into huge gradients.
"""
import argparse
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssar_tpu_torch.models import reactor as t_reactor
from ssar_tpu_torch.models._flax import flax_tree
from ssar_tpu_torch.train import data as t_data
from ssar_tpu_torch.train import losses as t_losses
from ssar_tpu_torch.train import train as t_train
from ssar_tpu_torch.utils import config as t_config

j_reactor = importlib.import_module("ssar_tpu.models.reactor")
j_losses = importlib.import_module("ssar_tpu.train.losses")
j_train = importlib.import_module("ssar_tpu.train.train")
j_data = importlib.import_module("ssar_tpu.train.data")
j_config = importlib.import_module("ssar_tpu.utils.config")


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * (np.abs(want).max() + 1e-30))


# -------------------------------------------------------------------- losses --
@pytest.mark.parametrize("dx,dy", [(5, 59), (70, 59), (59, 3)])
def test_procrustes_matches_jax(rng, dx, dy):
    x = rng.randn(3, 96, dx).astype(np.float32)
    y = rng.randn(3, 96, dy).astype(np.float32)
    want, want_g = jax.value_and_grad(lambda a: jnp.sum(jax.vmap(j_losses.orthogonal_procrustes_distance)(
        a, jnp.asarray(y))))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    got = t_losses.orthogonal_procrustes_distance(xt, torch.as_tensor(y))
    got.sum().backward()
    _close(got.sum().detach(), want, 1e-4)
    _close(xt.grad, want_g, 1e-3)


def test_audio_reactive_and_supervised_losses_match_jax(rng):
    a = [rng.randn(2, 96, 4, 4).astype(np.float32), rng.randn(2, 96, 3).astype(np.float32)]
    v = [rng.randn(2, 96, 59).astype(np.float32)]
    want = j_losses.audio_reactive_loss([jnp.asarray(f) for f in a], [jnp.asarray(f) for f in v])
    got = t_losses.audio_reactive_loss([torch.as_tensor(f) for f in a], [torch.as_tensor(f) for f in v])
    _close(got, want, 1e-4)
    got_d = t_losses.audio_reactive_loss({"a": torch.as_tensor(a[0]), "b": torch.as_tensor(a[1])},
                                         {"v": torch.as_tensor(v[0])})
    _close(got_d, want, 1e-4)

    pl, tl = rng.randn(2, 8, 18, 4).astype(np.float32), rng.randn(2, 8, 18, 4).astype(np.float32)
    pn = [rng.randn(2, 8, s, s).astype(np.float32) for s in (4, 8)]
    tn = [rng.randn(2, 8, s, s).astype(np.float32) for s in (4, 8)]
    for j_fn, t_fn in ((j_losses.supervised_loss, t_losses.supervised_loss),
                       (j_losses.supervised_loss_per_example, t_losses.supervised_loss_per_example)):
        want = j_fn(jnp.asarray(pl), [jnp.asarray(n) for n in pn], jnp.asarray(tl), [jnp.asarray(n) for n in tn])
        got = t_fn(torch.as_tensor(pl), [torch.as_tensor(n) for n in pn], torch.as_tensor(tl),
                   [torch.as_tensor(n) for n in tn])
        _close(got, want, 1e-5)


def test_normalize_gradients_matches_jax(rng):
    x = rng.randn(4, 5).astype(np.float32)
    w = rng.randn(4, 5).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(j_losses.normalize_gradients(a, 2.0) * jnp.asarray(w) ** 2))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    (t_losses.normalize_gradients(xt, 2.0) * torch.as_tensor(w) ** 2).sum().backward()
    _close(xt.grad, want, 1e-6)


# ------------------------------------------------------------ one train step --
class _CaptureGrads:
    """A port optimizer that keeps the gradients and leaves the parameters."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def step(self, grads):
        self.grads = [g.clone() for g in grads]


def _capture_optax():
    """An optax transformation whose state after update is the gradient tree."""
    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _args(decoder, loss):
    return argparse.Namespace(decoder=decoder, residual=False, num_layers=2, backbone="sashimi", hidden_size=4,
                              n_latent_split=3, dropout=0.0, env_guard_eps=0.0, loss=loss)


def _step_pair(rng, monkeypatch, decoder, loss, B=2, T=96):
    ds = t_data.synthetic_dataset(n_windows=B, n_frames=T, seed=3)
    batch = tuple(np.asarray(a, np.float32) for a in ds.arrays)
    mean, std = t_data.compute_stats(ds.features)
    palette = rng.randn(12, 18, 512).astype(np.float32)
    args = _args(decoder, loss)
    jm = j_train.make_model(args, mean, std, palette)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, jnp.asarray(batch[0][:1])))
    if decoder == "fixed":  # lift the palette envelopes so their per-split sums stay away from 0
        out = variables["params"]["EnvelopeReactor_0"]["Dense_1"]
        out["bias"] = out["bias"] + np.where(np.arange(out["bias"].shape[0]) < 12, 1.0, 0.0).astype(np.float32)
    base = [rng.randn(B, T, s, s).astype(np.float32) for s in (4, 8, 16, 32)]
    j_it, t_it = iter(base), iter(base)
    monkeypatch.setattr(j_reactor, "_smoothed_noise", lambda key, bt, size, sigma=5.0: jnp.asarray(next(j_it)))
    monkeypatch.setattr(t_reactor, "smoothed_noise", lambda bt, size, sigma=5.0, generator=None, device=None:
                        torch.as_tensor(next(t_it)))

    opt = _capture_optax()
    train_step = j_train.make_train_step(jm, opt, loss)[0]
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    _, j_grads, j_loss, _ = train_step(jvars, opt.init(jvars), tuple(map(jnp.asarray, batch)),
                                       jax.random.PRNGKey(0))

    tm = t_train.make_model(args, mean, std, palette).load_flax(variables)
    capture = _CaptureGrads(tm.parameters())
    step = t_train.make_train_step(tm, capture, loss, device="cpu")[0]
    t_loss = step(tuple(map(torch.as_tensor, batch)), (None, None))
    for p, g in zip(capture.params, capture.grads):
        p.grad = g
    return float(j_loss), jax.tree_util.tree_map(np.asarray, j_grads["params"]), float(t_loss), flax_tree(tm, grad=True)


# selfsupervised runs at the real window, T = 192, and its loss at rtol 2e-4:
# the 59 x 59 Gram of a freshly initialised fixed decoder has many tiny
# eigenvalues, and sqrt turns their float32 round-off into ~1e-4 of the loss
@pytest.mark.parametrize("decoder,loss,T,loss_rtol", [("fixed", "ssabsdiff", 96, 1e-4),
                                                      ("fixed", "selfsupervised", 192, 2e-4),
                                                      ("fixed", "supervised", 96, 1e-4),
                                                      ("learned", "supervised", 96, 1e-4)])
def test_train_step_loss_and_grads_match_jax(rng, monkeypatch, decoder, loss, T, loss_rtol):
    j_loss, j_grads, t_loss, t_grads = _step_pair(rng, monkeypatch, decoder, loss, T=T)
    np.testing.assert_allclose(t_loss, j_loss, rtol=loss_rtol)
    flat_j = jax.tree_util.tree_leaves_with_path(j_grads)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(t_grads))
    assert len(flat_j) == len(flat_t)
    for path, gj in flat_j:
        gt = flat_t[path].numpy()
        np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-3 * np.abs(gj).max() + 1e-30,
                                   err_msg=jax.tree_util.keystr(path))


def test_eval_step_matches_jax(rng, monkeypatch):
    """JAX's eval_step (jitted) and the port's, ssabsdiff mode, injected noise."""
    B, T = 2, 96
    ds = t_data.synthetic_dataset(n_windows=B, n_frames=T, seed=5)
    batch = tuple(np.asarray(a, np.float32) for a in ds.arrays)
    mean, std = t_data.compute_stats(ds.features)
    palette = rng.randn(12, 18, 512).astype(np.float32)
    args = _args("fixed", "ssabsdiff")
    args.env_guard_eps = 0.5
    jm = j_train.make_model(args, mean, std, palette)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, jnp.asarray(batch[0][:1])))
    base = [rng.randn(B, T, s, s).astype(np.float32) for s in (4, 8, 16, 32)]
    j_it, t_it = iter(base), iter(base)
    monkeypatch.setattr(j_reactor, "_smoothed_noise", lambda key, bt, size, sigma=5.0: jnp.asarray(next(j_it)))
    monkeypatch.setattr(t_reactor, "smoothed_noise", lambda bt, size, sigma=5.0, generator=None, device=None:
                        torch.as_tensor(next(t_it)))
    eval_j = j_train.make_train_step(jm, optax.adam(1e-3), "ssabsdiff")[2]
    j_mode, j_mse, j_sample, _ = eval_j(jax.tree_util.tree_map(jnp.asarray, variables),
                                        tuple(map(jnp.asarray, batch)), jax.random.PRNGKey(0))
    tm = t_train.make_model(args, mean, std, palette).load_flax(variables)
    opt = t_train.ClippedAdam(tm.parameters(), 1e-3)
    eval_t = t_train.make_train_step(tm, opt, "ssabsdiff", device="cpu")[2]
    t_mode, t_mse, t_sample, t_seq = eval_t(tuple(map(torch.as_tensor, batch)), None)
    _close(t_mode, j_mode, 1e-4)
    _close(t_mse, j_mse, 1e-4)
    _close(t_sample, j_sample, 1e-4)
    assert t_seq.shape == (B, T, 18 * 512)


# ----------------------------------------------------------------- optimizer --
def test_clipped_adam_matches_optax(rng):
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.as_tensor(p).clone() for p in params]
    opt = t_train.ClippedAdam(tp, 1e-2, grad_clip=1.0)
    for k, scale in enumerate((0.05, 3.0, 0.2, 10.0, 0.01)):  # below and above the clip
        grads = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.as_tensor(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=f"step {k}")
    assert int(opt.count) == 5


# ---------------------------------------------------------------------- data --
def test_data_pipeline_matches_jax():
    t_ds = t_data.synthetic_dataset(n_windows=6, n_frames=40, seed=11)
    j_ds = j_data.synthetic_dataset(n_windows=6, n_frames=40, seed=11)
    for a, b in zip(t_ds.arrays, (j_ds.features, j_ds.latents, *j_ds.noises)):
        np.testing.assert_array_equal(a, b)
    t_idx, j_idx = t_ds.index_batches(4, seed=3), j_ds.index_batches(4, seed=3)
    for _ in range(5):
        np.testing.assert_array_equal(next(t_idx), next(j_idx))
    for tb, jb in zip(t_ds.batches(4, seed=1, loop=False), j_ds.batches(4, seed=1, loop=False)):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
    arr = np.arange(50 * 3).reshape(50, 3)
    np.testing.assert_array_equal(t_data.overlapping_slices(arr, 16), j_data.overlapping_slices(arr, 16))
    assert t_data.overlapping_slices(arr[:4], 16).shape == (0, 16, 3)
    files = [f"track{i}" for i in range(20)]
    assert t_data.train_val_split(files) == j_data.train_val_split(files)
    for a, b in zip(t_data.compute_stats(t_ds.features), j_data.compute_stats(j_ds.features)):
        np.testing.assert_array_equal(a, b)
    dev = t_ds.to_device("cpu")
    assert [tuple(a.shape) for a in dev] == [a.shape for a in t_ds.arrays]


def test_config_file_matches_jax(tmp_path):
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({"train": {"lr": 3e-4, "batch_size": 4}, "model": {"backbone": "sashimi"},
                               "unknown_key": 1}))
    argv = ["--batch_size", "8", "--config", str(cfg)]
    parser = t_train.build_parser()
    got = vars(t_config.apply_config_file(parser, parser.parse_args(argv), str(cfg), argv))
    want = vars(j_config.apply_config_file(parser, parser.parse_args(argv), str(cfg), argv))
    assert got == want and got["lr"] == 3e-4 and got["batch_size"] == 8 and got["backbone"] == "sashimi"


# ----------------------------------------------------------------- the trainer --
_TINY = ["--decoder", "fixed", "--backbone", "sashimi", "--loss", "ssabsdiff", "--hidden_size", "4",
         "--num_layers", "1", "--duration", "4", "--batch_size", "8", "--eval_every", "100000",
         "--no-render_at_ckpt", "--no-fcd", "--device", "cpu"]   # the FCD has tests of its own


def _final_state(log_dir):
    return torch.load(t_train._latest_checkpoint(log_dir), weights_only=True)


def test_resume_continues_where_the_run_left_off(tmp_path):
    """2 steps, checkpoint, resume for 2 more == 4 steps straight."""
    straight, _ = t_train.main(_TINY + ["--n_examples", "32", "--out_dir", str(tmp_path / "a")])
    first, _ = t_train.main(_TINY + ["--n_examples", "16", "--out_dir", str(tmp_path / "b")])
    resumed, _ = t_train.main(_TINY + ["--n_examples", "32", "--out_dir", str(tmp_path / "c"),
                                       "--resume", str(first)])
    want, got = _final_state(straight), _final_state(resumed)
    assert want["step"] == got["step"] == 32 and _final_state(first)["step"] == 16
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert all(torch.equal(a, b) for a, b in zip(got["opt_state"]["mu"], want["opt_state"]["mu"]))
    lines = (straight / "metrics.csv").read_text().splitlines()
    assert sum(ln.split(",")[1] == "Loss/ssabsdiff" for ln in lines) == 4
    assert np.isfinite(json.loads((straight / "final_metrics.json").read_text())["val_loss"])


def test_checkpoint_render_writes_y4m_without_cv2(tmp_path, monkeypatch):
    args = t_train.build_parser().parse_args(_TINY + ["--duration", "1", "--render_size", "32"])
    mean, std = np.zeros(59, np.float32), np.ones(59, np.float32)
    model = t_train.make_model(args, mean, std, np.random.RandomState(0).randn(12, 18, 512).astype(np.float32))
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    out = t_train.render_checkpoint_sample(model, args, str(tmp_path / "sample.mp4"),
                                           gan_config=StyleGAN2Config(resolution=32, max_channels=32), device="cpu")
    assert out.endswith(".y4m")
    raw = open(out, "rb").read()
    header = b"YUV4MPEG2 W32 H32 F24:1 Ip A1:1 C420jpeg\n"
    assert raw.startswith(header) and len(raw) == len(header) + 24 * (6 + 32 * 48)


def test_trainer_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _TINY[:-2] + ["--n_examples", "8", "--out_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(args + ["--device", "cuda"])
    model = t_train.make_model(t_train.build_parser().parse_args(_TINY), np.zeros(59), np.ones(59),
                               np.zeros((12, 18, 512), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.make_train_step(model, t_train.ClippedAdam(model.parameters(), 1e-3), "ssabsdiff")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_data.synthetic_dataset(n_windows=2, n_frames=8).to_device()
    with pytest.raises(RuntimeError, match="CUDA"):   # --fcd (on by default) raises as the rest does
        t_train.main(args + ["--fcd"])


def test_preprocess_directory_matches_jax_and_trains_from_the_cache(tmp_path):
    """Three 4 s arpeggio tracks, each detuned by up to 0.3 semitones (the
    features estimate their own tuning here), with random W+ and noise
    targets: the same split, windows and targets, features within the
    docs/PARITY.md budgets; then one step of the port's trainer from its
    cache."""
    from scipy.io import wavfile

    from ssar_tpu_torch.audio.features import PARITY_BUDGETS

    sr, fps, rng = 1024 * 24, 24, np.random.RandomState(0)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    t = np.arange(4 * sr) / sr
    for i in range(3):
        notes = 220.0 * 2 ** (np.array([0, 4, 7, 12]) / 12) * 2 ** (rng.uniform(-0.3, 0.3) / 12)
        audio = 0.4 * np.sin(2 * np.pi * np.cumsum(notes[(t * 4).astype(int) % 4]) / sr) + 0.05 * rng.randn(len(t))
        audio[:: sr // 2] += 1.0
        wavfile.write(corpus / f"track{i}.wav", sr, audio.astype(np.float32))
        np.save(corpus / f"track{i}.npy", rng.randn(4 * fps, 18, 512).astype(np.float32))
        for s in (4, 8, 16, 32):
            np.save(corpus / f"track{i}_noise{s}.npy", rng.randn(4 * fps, s, s).astype(np.float32))
    meta_t = t_data.preprocess_directory(corpus, tmp_path / "t", dur=1, fps=fps, device="cpu")
    meta_j = j_data.preprocess_directory(corpus, tmp_path / "j", dur=1, fps=fps)
    assert meta_t == meta_j and meta_t["train"] and meta_t["val"]
    for split in ("train", "val"):
        got, want = t_data.load_cached(tmp_path / "t", split), j_data.load_cached(tmp_path / "j", split)
        assert got.features.shape == want.features.shape and len(got) > 0
        for group, (cols, budget) in PARITY_BUDGETS.items():
            assert np.abs(got.features[..., cols] - want.features[..., cols]).max() <= budget, (split, group)
        for a, b in zip(got.arrays[1:], (want.latents, *want.noises)):
            np.testing.assert_array_equal(a, b)

    log_dir, val_loss = t_train.main(["--cache_dir", str(tmp_path / "t"), "--out_dir", str(tmp_path / "runs"),
                                      "--decoder", "fixed", "--backbone", "sashimi", "--hidden_size", "4",
                                      "--num_layers", "1", "--duration", "1", "--batch_size", "4",
                                      "--n_examples", "4", "--no-render_at_ckpt", "--no-fcd", "--device", "cpu"])
    np.testing.assert_array_equal(np.load(log_dir / "input_mean.npy"), np.load(tmp_path / "t" / "train_mean.npy"))
    assert np.isfinite(val_loss)
