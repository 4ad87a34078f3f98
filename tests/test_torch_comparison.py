"""The paper's comparison harness in the port (``ssar_tpu_torch/metrics/``:
``analysis.py``, ``preliminary.py``, ``ood.py``, ``generate.py`` and the
predictors of ``comparison.py``) against the JAX package's, small, on the
CPU (the scoring, the sweeps and the study: tests/test_torch_study.py).  Both packages take the same numpy inputs made from a seed; random
draws are JAX's, injected into ``generate/keys.py``.  Tolerances:
- analysis, the preliminary study's primitives (on full-rank Grams), GAF,
  the default extractor, KID and PRDC within 1e-4 of the largest magnitude
  (float32 eigen / singular decompositions, compared up to the sign of a
  singular vector); JRP equal; MiniRocket's biases within 1e-5 and its PPV
  features within 1e-6 given equal biases;
- the recipes' clips within 1e-3 (the chroma and onset features are held at
  docs/PARITY.md's budgets);
- each predictor's latents within 1e-4 of JAX's (Lucid within 1e-3: its
  onsets and harmonic RMS at their budgets).
"""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.metrics import analysis as t_an
from ssar_tpu_torch.metrics import comparison as t_cmp
from ssar_tpu_torch.metrics import generate as t_gen
from ssar_tpu_torch.metrics import ood as t_ood
from ssar_tpu_torch.metrics import preliminary as t_pre
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import close, generator_pair, jax_keys

j_an = importlib.import_module("ssar_tpu.metrics.analysis")
j_pre = importlib.import_module("ssar_tpu.metrics.preliminary")
j_ood = importlib.import_module("ssar_tpu.metrics.ood")
j_gen = importlib.import_module("ssar_tpu.metrics.generate")
j_cmp = importlib.import_module("ssar_tpu.metrics.comparison")

FPS = 24
SR = 1024 * FPS


def _track(seconds: float = 2.0):
    """A quiet 220 Hz half and a noisy 330 Hz half with a click every half
    second: both packages estimate the same tuning on its harmonic part."""
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.RandomState(0)
    half = seconds / 2
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < half, 220.0, 330.0)) / SR)
             + np.where(t < half, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: SR // 2] += 1.0
    return audio


AUDIO = _track()
T = len(AUDIO) // 1024  # 48


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _spd(rng, n=6, m=40):
    x = rng.randn(m, n).astype(np.float32)
    return x, (x.T @ x / m + 0.1 * np.eye(n)).astype(np.float32)


# ------------------------------------------------------------------ analysis --
def test_analysis_matches_jax():
    rng = np.random.RandomState(0)
    x, A = _spd(rng)
    y, B = _spd(rng)
    close(t_an.covariance(torch.as_tensor(x)), j_an.covariance(jnp.asarray(x)), 1e-5, "covariance")
    for name, fn in t_an.COVARIANCE_DISTANCES.items():
        got = fn(torch.as_tensor(A), torch.as_tensor(B))
        close(got, j_an.COVARIANCE_DISTANCES[name](jnp.asarray(A), jnp.asarray(B)), 1e-4, name)
    close(t_an.knn_kl_divergence(torch.as_tensor(x), torch.as_tensor(y)),
          j_an.knn_kl_divergence(jnp.asarray(x), jnp.asarray(y)), 1e-4, "knn_kl")
    close(t_an.mutual_information(torch.as_tensor(x[:, 0]), torch.as_tensor(x[:, 1] + x[:, 0])),
          j_an.mutual_information(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1] + x[:, 0])), 1e-4, "mi")
    comps, var, proj = t_an.pca(torch.as_tensor(x), 3)
    jc, jv, jp = j_an.pca(jnp.asarray(x), 3)
    signs = np.sign(np.sum(_np(comps) * np.asarray(jc), axis=1))
    close(_np(comps) * signs[:, None], jc, 1e-4, "components")
    close(var, jv, 1e-4, "variance")
    close(_np(proj) * signs, jp, 1e-4, "projection")


# --------------------------------------------------------------- preliminary --
def test_preliminary_primitives_match_jax():
    rng = np.random.RandomState(1)
    X = rng.randn(3, 8, 10).astype(np.float32)   # full-rank time-Grams: the square roots are well conditioned
    Y = rng.randn(3, 8, 12).astype(np.float32)
    tX, tY, jX, jY = torch.as_tensor(X), torch.as_tensor(Y), jnp.asarray(X), jnp.asarray(Y)
    close(t_pre.standardize(tX), j_pre.standardize(jX), 1e-5, "standardize")
    gx, gy = t_pre.time_gram(tX), t_pre.time_gram(tY)
    jgx, jgy = j_pre.time_gram(jX), j_pre.time_gram(jY)
    close(gx, jgx, 1e-5, "time_gram")
    close(t_pre.trace_correlation_distance(gx, gy), j_pre.trace_correlation_distance(jgx, jgy), 1e-5, "trace")
    close(t_pre.bures_distance_batched(gx, gy), j_pre.bures_distance_batched(jgx, jgy), 1e-4, "bures")
    _, A = _spd(rng, 5)
    _, B = _spd(rng, 5)
    A3, B3 = np.stack([A, B]), np.stack([B, A])
    for name in ("kullback_distance", "condition_distance"):
        close(getattr(t_pre, name)(torch.as_tensor(A3), torch.as_tensor(B3)),
              getattr(j_pre, name)(jnp.asarray(A3), jnp.asarray(B3)), 1e-4, name)
    for name, kw in (("pca_svd", {}), ("pca_eig", {}), ("pca_eig", {"scale": True})):
        got, want = _np(getattr(t_pre, name)(tX, 2, **kw)), np.asarray(getattr(j_pre, name)(jX, 2, **kw))
        signs = np.sign(np.sum(got * want, axis=(0, 1)))
        close(got * signs, want, 1e-4, name)
    for method in ("summation", "difference"):
        close(t_pre.gramian_angular_field(tX, method), j_pre.gramian_angular_field(jX, method), 1e-5, method)
    close(t_pre.gramian_angular_field(tX[0]), j_pre.gramian_angular_field(jX[0]), 1e-5, "gaf 2-D")
    assert np.array_equal(_np(t_pre.joint_recurrence_plot(tX)), np.asarray(j_pre.joint_recurrence_plot(jX)))


def test_minirocket_matches_jax():
    X = np.random.RandomState(2).randn(3, 40, 2).astype(np.float32)
    got, want = t_pre.minirocket_fit(X), j_pre.minirocket_fit(X)
    assert np.array_equal(got["dilations"], want["dilations"]) and np.array_equal(got["mix"], want["mix"])
    close(got["biases"], want["biases"], 1e-5, "biases")
    # the same biases in: the same PPV features out (XLA's mean multiplies by 1 / t: an ulp)
    close(t_pre.minirocket_transform(X, want), j_pre.minirocket_transform(X, want), 1e-6, "ppv")
    assert t_pre.minirocket_transform(X, got).shape == (3, 4 * len(got["dilations"]) * 84)


def _groups(rng, m=5, t=16):
    return {"a": {"video_feat": rng.randn(m, t, 3), "audio_feat": rng.randn(m, t, 2), "audio_chroma": rng.randn(m, t),
                  "video_onsets": rng.rand(m, t), "audio_onsets": rng.rand(m, t),
                  "video_tempogram": rng.rand(m, t, 4), "audio_tempogram": rng.rand(m, t, 4)},
            "b": {"video_feat": rng.randn(m + 1, t, 3), "audio_feat": rng.randn(m + 1, t, 2)}}


def test_preliminary_study_matches_jax(monkeypatch, tmp_path):
    jax_keys(monkeypatch)
    rng = np.random.RandomState(3)
    groups = _groups(rng)
    v = {"f": rng.randn(4, 10, 3).astype(np.float32)}
    a = {"g": rng.randn(4, 10).astype(np.float32)}
    for mis in (False, True):
        got = t_pre.compare_av_feats({k: torch.as_tensor(x) for k, x in v.items()},
                                     {k: torch.as_tensor(x) for k, x in a.items()}, jax.random.PRNGKey(5), mis)
        want = j_pre.compare_av_feats(v, a, jax.random.PRNGKey(5), mis)
        assert got.keys() == want.keys()
        close(np.array(list(got.values())), np.array(list(want.values())), 1e-4, f"compare_av_feats {mis}")
    got = t_pre.preliminary_study(groups, ["video_feat"], ["audio_feat"], n_samples=4, out_dir=str(tmp_path / "t"),
                                  device="cpu")
    want = j_pre.preliminary_study(groups, ["video_feat"], ["audio_feat"], n_samples=4, out_dir=str(tmp_path / "j"))
    for rows_t, rows_j in zip(got, want):
        assert [sorted(r) for r in rows_t] == [sorted(r) for r in rows_j]
        for rt, rj in zip(rows_t, rows_j):
            assert rt["group"] == rj["group"]
            keys_ = sorted(k for k in rj if k != "group")
            close(np.array([rt[k] for k in keys_]), np.array([rj[k] for k in keys_]), 1e-4, rj["group"])
    assert "dtw_med" in got[0][0] and got[1][0]["avmi"] != 0.0
    for name in ("aligned.csv", "misaligned.csv"):
        assert (tmp_path / "t" / name).read_text().splitlines()[0] == (tmp_path / "j" / name).read_text().splitlines()[0]


# ----------------------------------------------------------------------- ood --
def test_ood_metrics_match_jax(monkeypatch):
    jax_keys(monkeypatch)
    rng = np.random.RandomState(4)
    a, b = rng.randn(20, 8), rng.randn(24, 8) + 0.3
    assert t_ood.kernel_distance(a, b) == pytest.approx(j_ood.kernel_distance(a, b), rel=1e-10)
    assert t_ood.prdc(a, b) == j_ood.prdc(a, b)
    imgs = rng.rand(6, 24, 24, 3).astype(np.float32)
    close(t_ood.default_extractor()(torch.as_tensor(imgs)), j_ood.default_extractor()(jnp.asarray(imgs)), 1e-4,
          "default extractor")
    real, fake = rng.rand(12, 3, 16, 16).astype(np.float32), rng.rand(12, 16, 16, 3).astype(np.float32) ** 2
    with pytest.warns(UserWarning, match="random-projection"):
        got = t_ood.compute(real, fake, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_ood.compute(real, fake)
    assert got.keys() == want.keys()
    close(np.array(list(got.values())), np.array(list(want.values())), 1e-4, "compute")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_ood.compute(real, fake, allow_random_extractor=True, device="cpu")


def test_discriminator_extractor_matches_jax():
    from ssar_tpu.gan.discriminator import Discriminator as JD

    dp = jax.tree_util.tree_map(np.asarray, JD(resolution=16, channel_multiplier=1).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3))))
    imgs = np.random.RandomState(5).rand(10, 16, 16, 3).astype(np.float32)
    got = t_ood.discriminator_extractor(dp, resolution=16, batch_size=4)(torch.as_tensor(imgs))
    want = j_ood.discriminator_extractor(dp, resolution=16, batch_size=4)(jnp.asarray(imgs))
    assert got.shape == (10, 512)
    close(got, want, 1e-4, "discriminator features")


@pytest.fixture(scope="module")
def g_pair(tmp_path_factory):
    return generator_pair(tmp_path_factory.mktemp("g") / "g.npz")


def test_video_vs_generator_matches_jax(monkeypatch, g_pair):
    jax_keys(monkeypatch)
    jG, tG = g_pair
    frames = np.random.RandomState(6).rand(10, 3, 24, 24).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = t_ood.video_vs_generator(frames, tG, n_samples=10, batch_size=4, size=16)
        want = j_ood.video_vs_generator(frames, jG, n_samples=10, batch_size=4, size=16)
    assert got.keys() == want.keys()
    close(np.array(list(got.values())), np.array(list(want.values())), 1e-4, "video_vs_generator")


# ------------------------------------------------------------------- recipes --
@pytest.mark.parametrize("recipe", list(j_gen.CORRELATION_RECIPES))
def test_correlation_recipes_match_jax(monkeypatch, g_pair, recipe):
    jax_keys(monkeypatch)
    jG, tG = g_pair
    want = np.asarray(j_gen.render_correlation_clip(recipe, AUDIO, SR, jG, seed=7))
    got = t_gen.render_correlation_clip(recipe, AUDIO, SR, tG, seed=7)
    assert got.shape == want.shape == (T, 3, 16, 16)
    close(got, want, 1e-3, recipe)


# ---------------------------------------------------------------- predictors --
def test_lucid_baseline_matches_jax(monkeypatch, g_pair):
    jax_keys(monkeypatch)
    jG, tG = g_pair
    want, _ = j_cmp.LucidSonicBaseline(jG, seed=3).predict(AUDIO, SR)
    got, none = t_cmp.LucidSonicBaseline(tG, seed=3).predict(AUDIO, SR)
    assert none is None
    close(got, want, 1e-3, "lucid latents")
    bare, _ = t_cmp.LucidSonicBaseline(None, seed=3, device="cpu").predict(AUDIO, SR)
    assert bare.shape == (T, 18, 512)


def test_supervised_sequence_model_matches_jax(monkeypatch, g_pair):
    """A GRU reactor with the same flax weights and base noise, residual on
    the mapper latent of PRNGKey(1)'s z."""
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor

    j_reactor = importlib.import_module("ssar_tpu.models.reactor")
    j_feat = importlib.import_module("ssar_tpu.audio.features")
    jax_keys(monkeypatch)
    jG, tG = g_pair
    rng = np.random.RandomState(9)
    H, n_ws = 4, jG.config.n_latent
    palette = rng.randn(3 * H, n_ws, 512).astype(np.float32)
    base = {2 ** (i + 2): rng.randn(1, T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(4)}
    mean, std = np.zeros(59, np.float32), np.ones(59, np.float32)
    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(palette), backbone="gru",
                                      hidden_size=H, num_layers=1, env_guard_eps=0.1)
    # the same feature stack in both (its own parity: tests/test_torch_audio.py)
    feats = rng.randn(T, 59).astype(np.float32)
    monkeypatch.setattr(j_feat, "audio2features", lambda audio, sr, fps: jnp.asarray(feats))
    monkeypatch.setattr(importlib.import_module("ssar_tpu_torch.audio.features"), "audio2features",
                        lambda audio, sr, fps, device=None: torch.as_tensor(feats, device=device))
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, jnp.asarray(feats[None])))
    out = variables["params"]["EnvelopeReactor_0"]["Dense_1"]
    out["bias"] = out["bias"] + np.where(np.arange(out["bias"].shape[0]) < 3 * H, 1.0, 0.0).astype(np.float32)
    monkeypatch.setattr(j_reactor, "_smoothed_noise", lambda key, bt, size, sigma=5.0: jnp.asarray(base[size]))
    tm = LatentNoiseReactor(mean, std, palette, backbone="gru", hidden_size=H, num_layers=1, env_guard_eps=0.1)
    tm.load_flax(variables)
    monkeypatch.setattr(tm.decoder, "forward", lambda x, base_noise=None, generator=None, _f=tm.decoder.forward:
                        _f(x, base_noise=[base[2 ** (i + 2)] for i in range(4)]))
    want_l, want_n = j_cmp.SupervisedSequenceModel(jm, variables, residual=True, G=jG).predict(AUDIO, SR)
    got_l, got_n = t_cmp.SupervisedSequenceModel(tm, residual=True, G=tG).predict(AUDIO, SR)
    close(got_l, want_l, 1e-4, "latents")
    for g, w in zip(got_n, want_n):
        close(g, w, 1e-4, "noise")


def test_self_supervised_optimization_passes_the_comparison_settings(monkeypatch):
    """The predictor hands ``optimize`` the comparison's configuration, as the
    JAX package's does (the optimizer itself: tests/test_torch_optimize.py)."""
    seen = {}

    def fake(name):
        def optimize(**kw):
            seen[name] = kw
            return None, np.zeros((T, 18, 512), np.float32), [], [1.0]
        return optimize

    monkeypatch.setattr(importlib.import_module("ssar_tpu.generate.optimize"), "optimize", fake("jax"))
    monkeypatch.setattr(importlib.import_module("ssar_tpu_torch.generate.optimize"), "optimize", fake("port"))
    j_cmp.SelfSupervisedOptimization(n_steps=7, lambda_amplitude=2.0).predict(AUDIO, SR)
    model = t_cmp.SelfSupervisedOptimization(n_steps=7, lambda_amplitude=2.0, device="cpu")
    model.predict(AUDIO, SR)
    assert model.loss_curves == [[1.0]] and seen["port"].pop("device") == "cpu"
    jax_kw, port_kw = seen["jax"], seen["port"]
    assert np.array_equal(jax_kw.pop("audio"), port_kw.pop("audio"))
    assert port_kw == jax_kw
