"""The port's trainers vs the JAX package's, on the CPU: one step of each from
the same weights and batch, with JAX's draws.

Each JAX trainer runs one step from the weights its own seeds give; the test
builds those weights the same way and hands them to the port's trainer
(``params`` / ``g_params`` / ``d_params``), with ``generate/keys.py``
replaced by ``jax.random`` wrappers so that both draw the same noise, patch
starts and frames.  Tolerances: losses within 1e-5 relative, parameters
after the Adam step within 1e-4 of the largest magnitude (``_params_close``
says where a gradient within ~10 eps of zero lets round-off set Adam's
step).  A GAN's G loss
comes after its D step in the same iteration, where Adam's first update
(b1 = 0) moves every parameter by ~lr whatever its gradient's size, so a
round-off gradient of either sign moves D by +-lr: that loss is held at 1e-4
relative.  The calibration G's parity runs its synthesis in float32 in both
packages (the JAX package's bf16 swapped for float32 in its module; XLA and
torch round bf16 at different points, 1e-3 apart in the loss), its
adversarial case at 16 px: the JAX package's 32 px discriminator (512
channels at every level) alone takes 42-57 s of CPU.  Then the trainer's FCD
on the CPU.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.gan import discriminator as td
from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.models._flax import flax_tree
from ssar_tpu_torch.train import data as t_data
from ssar_tpu_torch.train import palette_g as tpg
from ssar_tpu_torch.train import train as t_train
from ssar_tpu_torch.train import trainers as tt
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import jax_keys, np_tree, tree_close

jt = importlib.import_module("ssar_tpu.train.trainers")
j_data = importlib.import_module("ssar_tpu.train.data")
ja = importlib.import_module("ssar_tpu.models.audio2latent")
jp = importlib.import_module("ssar_tpu.models.psagan")
jss = importlib.import_module("ssar_tpu.models.selfsupervised")
jd = importlib.import_module("ssar_tpu.gan.discriminator")
js = importlib.import_module("ssar_tpu.gan.stylegan2")
jpg = importlib.import_module("ssar_tpu.train.palette_g")

B = 2


def _data(n_frames=16):
    return j_data.synthetic_dataset(n_windows=4, n_frames=n_frames, seed=3), \
        t_data.synthetic_dataset(n_windows=4, n_frames=n_frames, seed=3)


def _params_close(got: dict, want: dict, init: dict, lr: float, what: str, rtol: float = 1e-4):
    """Parameters after the step within rtol of the tree's largest magnitude,
    but where Adam's first update in JAX fell short of 0.9 lr: there the
    gradient is within ~10 eps (1e-8) of zero, its normalised step is set by
    round-off, and the two may differ by up to 2 lr (at most 0.1 % of the
    entries)."""
    flat = [jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, t)) for t in (want, init)]
    g_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t), got, is_leaf=torch.is_tensor))
    assert len(g_leaves) == len(flat[0]) == len(flat[1]), what
    scale = max(float(np.abs(w).max()) for w in flat[0])
    n_eps = n = 0
    for g, w, i in zip(g_leaves, *flat):
        err = np.abs(g.astype(np.float64) - w)
        eps_regime = np.abs(w - i) < 0.9 * lr
        assert np.all(err[~eps_regime] <= rtol * scale), (what, float(err[~eps_regime].max()), rtol * scale)
        assert np.all(err[eps_regime] <= 2 * lr), (what, float(err[eps_regime].max()))
        n_eps += int((eps_regime & (err > rtol * scale)).sum())
        n += w.size
    assert n_eps <= 1e-3 * n, (what, n_eps, n)


def _losses_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (got, want)


def test_train_audio2latent_step_matches_jax(monkeypatch):
    jax_keys(monkeypatch)
    jds, tds = _data()
    mean, std = j_data.compute_stats(jds.features)
    jm = ja.Audio2Latent(jnp.asarray(mean), jnp.asarray(std), hidden_size=8, num_layers=2, backbone="gru")
    init = np_tree(jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           jnp.asarray(jds.features[:B])))
    _, j_params, j_metrics = jt.train_audio2latent(jds, n_steps=1, batch_size=B, hidden_size=8, num_layers=2)
    model, metrics = tt.train_audio2latent(tds, n_steps=1, batch_size=B, hidden_size=8, num_layers=2,
                                           device="cpu", params=init)
    _losses_close(metrics["losses"], j_metrics["losses"])
    _params_close(flax_tree(model), np_tree(j_params["params"]), init["params"], 1e-4, "a2l")


def test_train_psagan_step_matches_jax(monkeypatch):
    jax_keys(monkeypatch)
    jds, tds = _data()
    G, D = jp.ProgressiveGenerator(out_dim=128, features=8, n_stages=2), \
        jp.ProgressiveDiscriminator(features=8, n_stages=2)
    feats0 = jnp.asarray(jds.features[:B])
    gp = G.init(jax.random.PRNGKey(0), feats0, jax.random.PRNGKey(1))
    dp = D.init(jax.random.PRNGKey(1), G.apply(gp, feats0, jax.random.PRNGKey(1)), feats0)
    (_, j_gp), (_, j_dp), j_metrics = jt.train_psagan(jds, n_steps=1, batch_size=B, features=8, n_stages=2)
    (tg, tdm), metrics = tt.train_psagan(tds, n_steps=1, batch_size=B, features=8, n_stages=2, device="cpu",
                                         g_params=np_tree(gp), d_params=np_tree(dp))
    _losses_close(metrics["d_losses"], j_metrics["d_losses"])
    _losses_close(metrics["g_losses"], j_metrics["g_losses"], 1e-4)
    _params_close(flax_tree(tg), np_tree(j_gp["params"]), np_tree(gp["params"]), 2e-4, "G")
    _params_close(flax_tree(tdm), np_tree(j_dp["params"]), np_tree(dp["params"]), 2e-4, "D")


def test_train_stylevideogan_step_matches_jax(monkeypatch):
    jax_keys(monkeypatch)
    wplus = np.random.RandomState(4).randn(4, 6, 2, 512).astype(np.float32) * 0.1
    G, D = jss.StyleVideoGenerator(n_styles=2, latent_dim=8), jss.StyleVideoDiscriminator(6, 2, 8)
    s0 = jax.random.normal(jax.random.PRNGKey(0), (B, 6, 8))
    gp = G.init(jax.random.PRNGKey(0), s0)
    dp = D.init(jax.random.PRNGKey(1), G.apply(gp, s0))
    (_, j_gp), (_, j_dp), j_metrics = jt.train_stylevideogan(wplus, n_steps=1, batch_size=B, latent_dim=8)
    (tg, tdm), metrics = tt.train_stylevideogan(wplus, n_steps=1, batch_size=B, latent_dim=8, device="cpu",
                                                g_params=np_tree(gp), d_params=np_tree(dp))
    _losses_close(metrics["d_losses"], j_metrics["d_losses"])
    _losses_close(metrics["g_losses"], j_metrics["g_losses"], 1e-4)
    _params_close(flax_tree(tg), np_tree(j_gp["params"]), np_tree(gp["params"]), 2e-4, "G")
    _params_close(flax_tree(tdm), np_tree(j_dp["params"]), np_tree(dp["params"]), 2e-4, "D")


@pytest.mark.parametrize("video", (False, True))
def test_train_sslstm_step_matches_jax(monkeypatch, video):
    """One contrastive step, and with the video-patch loss through a frozen
    32 px G (its parameters converted from the JAX package's)."""
    jax_keys(monkeypatch)
    jds, tds = _data()
    kw = dict(n_steps=1, batch_size=B, hidden_size=6, num_layers=2, n_patches=4, patch_len=4)
    model, contrastor = jss.LSTMReactor(hidden_size=6, num_layers=2), jss.PatchContrastor()
    x0, m0 = jnp.asarray(jds.features[:B]), jnp.zeros((B, 6))
    mp = model.init({"params": jax.random.PRNGKey(0), "zoneout": jax.random.PRNGKey(1)}, x0, m0)
    w0, _, _ = model.apply(mp, x0, m0)
    pa0 = jss.sample_patches_1d(jax.random.PRNGKey(0), w0.reshape(B, w0.shape[1], -1), 4, 4)
    pb0 = jss.sample_patches_1d(jax.random.PRNGKey(0), x0, 4, 4)
    init = {"model": mp, "contrastor": contrastor.init(jax.random.PRNGKey(1), pa0, pb0)}
    gan = {}
    if video:
        cfg = js.StyleGAN2Config(resolution=32, max_channels=16)
        gparams = js.init_generator(jax.random.PRNGKey(5), cfg)
        _, f0 = js.synthesis(gparams, w0[:, :2].reshape(-1, 18, 512), None, cfg, return_features=True,
                             output_size=32)
        pooled0 = jnp.concatenate([jnp.mean(f.astype(jnp.float32), axis=(1, 2)) for f in f0], -1).reshape(B, -1)
        pv0 = jnp.repeat(pooled0, 4, axis=0)[: pb0.shape[0]]
        init["video_contrastor"] = jss.PatchContrastor().init(jax.random.PRNGKey(2), pv0, pb0)
        gan = dict(gan_config=cfg, video_patch_weight=0.5)
        j_gan, t_gan = gparams, ts.params_from_jax(np_tree(gparams))
    _, j_params, j_metrics = jt.train_sslstm(jds, **kw, **gan, gan_params=j_gan if video else None)
    (tm, tc, tv), metrics = tt.train_sslstm(tds, **kw, **gan, gan_params=t_gan if video else None, device="cpu",
                                            params=np_tree(init))
    _losses_close(metrics["losses"], j_metrics["losses"])
    init = np_tree(init)
    _params_close(flax_tree(tm), np_tree(j_params["model"]["params"]), init["model"]["params"], 1e-4, "model")
    _params_close(flax_tree(tc), np_tree(j_params["contrastor"]["params"]), init["contrastor"]["params"], 1e-4,
                  "contrastor")
    if video:
        _params_close(flax_tree(tv), np_tree(j_params["video_contrastor"]["params"]),
                      init["video_contrastor"]["params"], 1e-4, "video")


class _Float32Numpy:
    """``jax.numpy`` with ``bfloat16`` meaning float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("lambda_adv,res", [(0.0, 32), (0.05, 16)])
def test_train_calibration_g_step_matches_jax(monkeypatch, lambda_adv, res):
    """One (D step with R1, G step) pair, float32 synthesis; the mapping unchanged."""
    jax_keys(monkeypatch)
    monkeypatch.setattr(jpg, "jnp", _Float32Numpy())
    cfg_j, cfg_t = js.StyleGAN2Config(resolution=res, max_channels=16), ts.StyleGAN2Config(resolution=res,
                                                                                          max_channels=16)
    gp = np_tree(js.init_generator(jax.random.PRNGKey(0), cfg_j))
    d_init = None
    if lambda_adv:
        d_init = np_tree(jd.Discriminator(resolution=res, channel_multiplier=1).init(
            jax.random.PRNGKey(1), jnp.zeros((2, res, res, 3), jnp.float32)))
    j_params, j_dp, j_losses = jpg.train_calibration_g(cfg_j, n_steps=1, batch_size=B, lambda_adv=lambda_adv,
                                                       progress=False)
    t_params, t_D, t_losses = tpg.train_calibration_g(cfg_t, n_steps=1, batch_size=B, lambda_adv=lambda_adv,
                                                      progress=False, device="cpu", dtype=torch.float32,
                                                      params=ts.params_from_jax(gp), d_params=d_init)
    for k in ("mse", "d_loss", "g_adv"):
        _losses_close(t_losses[k], j_losses[k])
    got = ts.params_to_jax(t_params)
    _params_close(got, np_tree(j_params), gp, 2e-3, "G")
    tree_close(got["mapping"], gp["mapping"], 0.0, "mapping")
    if lambda_adv:
        _params_close(td.discriminator_flax_tree(t_D), np_tree(j_dp["params"]), d_init["params"], 2e-3, "D")


def test_train_calibration_g_bf16_default_runs():
    """The default bf16 synthesis: finite losses, the mapping unchanged, the
    caller's weights left as they were."""
    cfg = ts.StyleGAN2Config(resolution=16, max_channels=16)
    init = ts.init_generator(cfg, torch.Generator().manual_seed(0))
    before = ts.params_to_jax(init)
    params, D, losses = tpg.train_calibration_g(cfg, n_steps=2, batch_size=B, progress=False, device="cpu",
                                                params=init)
    assert all(np.isfinite(v).all() for v in losses.values()) and D is not None
    tree_close(ts.params_to_jax(params)["mapping"], np_tree(before["mapping"]), 0.0, "mapping")
    tree_close(ts.params_to_jax(init), np_tree(before), 0.0, "caller's weights")
    assert not torch.equal(params["convs"][0]["weight"], init["convs"][0]["weight"])


def test_train_audio2latent_eval_fcd_on_the_cpu():
    _, tds = _data()
    _, metrics = tt.train_audio2latent(tds, n_steps=3, batch_size=B, hidden_size=8, num_layers=1,
                                       eval_fcd=True, device="cpu")
    assert len(metrics["losses"]) == 3 and np.isfinite(metrics["fcd"]) and metrics["fcd"] >= 0


def test_trainer_logs_fcd_by_default(tmp_path):
    """``--fcd`` is on by default, as in the JAX trainer: the eval logs Eval/FCD."""
    assert t_train.build_parser().parse_args([]).fcd
    log_dir, _ = t_train.main(["--smoke", "--backbone", "mlp", "--num_layers", "1", "--hidden_size", "4",
                               "--duration", "1", "--n_examples", "8", "--no-render_at_ckpt", "--device", "cpu",
                               "--out_dir", str(tmp_path)])
    rows = [ln.split(",") for ln in (log_dir / "metrics.csv").read_text().splitlines()]
    fcd = [float(v) for _, tag, v in rows if tag == "Eval/FCD"]
    assert len(fcd) == 1 and np.isfinite(fcd[0]) and fcd[0] >= 0
    assert json.loads((log_dir / "config.json").read_text())["fcd"] is True


def test_trainers_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tds = _data()
    for fn in (tt.train_audio2latent, tt.train_psagan, tt.train_sslstm):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(tds, n_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.train_stylevideogan(np.zeros((2, 6, 2, 512), np.float32), n_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpg.train_calibration_g(ts.StyleGAN2Config(resolution=8, max_channels=8), n_steps=1)


@pytest.mark.parametrize("fn,n", [("palette_identity_spread", 6), ("palette_target_alignment", 8)])
def test_palette_diagnostics_match_jax(monkeypatch, fn, n):
    """Both diagnostics in float32 on a random 32 px G, JAX's z injected."""
    jax_keys(monkeypatch)
    monkeypatch.setattr(jpg, "jnp", _Float32Numpy())
    cfg_j, cfg_t = js.StyleGAN2Config(resolution=32, max_channels=16), ts.StyleGAN2Config(resolution=32,
                                                                                        max_channels=16)
    gp = np_tree(js.init_generator(jax.random.PRNGKey(0), cfg_j))
    want = getattr(jpg, fn)(jax.tree_util.tree_map(jnp.asarray, gp), cfg_j, n=n, seed=3)
    got = getattr(tpg, fn)(ts.params_from_jax(gp), cfg_t, n=n, seed=3, dtype=torch.float32)
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def test_palette_target_alignment_of_the_calibration_g_matches_jax(monkeypatch):
    """The committed calibration G (docs/study/calibration_g.npz, 256 px): the
    port's alignment against the JAX package's on the same file, float32
    synthesis, 4 latents (JAX's z injected)."""
    from pathlib import Path

    from ssar_tpu_torch.gan.convert import load_npz

    path = Path(__file__).resolve().parents[1] / "docs" / "study" / "calibration_g.npz"
    jax_keys(monkeypatch)
    monkeypatch.setattr(jpg, "jnp", _Float32Numpy())
    cfg = dict(resolution=256, max_channels=128)
    j_convert = importlib.import_module("ssar_tpu.gan.convert")
    want = jpg.palette_target_alignment(j_convert.load_npz(str(path)), js.StyleGAN2Config(**cfg), n=4)
    got = tpg.palette_target_alignment(load_npz(str(path)), ts.StyleGAN2Config(**cfg), n=4, dtype=torch.float32)
    assert abs(got - want) <= 1e-4, (got, want)
    assert want > 0.5   # the trained G's colours follow W (the committed run reads 0.970 at n = 32)
