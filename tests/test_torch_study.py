"""The port's scoring of the paper's comparison (``evaluate_clip``,
``compare_models``, ``from_video_dir``, ``supplementary_material`` and the
random-patch predictor in
``ssar_tpu_torch/metrics/comparison.py``) and the AV feature study
(``metrics/study.py``) against the JAX package's, on a 1 s clip at 16 px on
the CPU.  Tolerances:
- ``evaluate_clip``'s 128 px video within 1e-4 and every record entry within
  2e-3 absolute (flow, histogram and directogram features pass through
  whole-pixel and bin-edge steps, ROADMAP C); ``from_video_dir`` the same;
- the random patch's latents and noise windows within 1e-4 (the same music
  information in both packages, JAX's draws injected);
- the study's correlation panel within 1e-4 on the same full-rank features
  (the SVD-based measures are not unique on rank-deficient ones); the
  report's statistics equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.metrics import comparison as t_cmp
from ssar_tpu_torch.metrics import study as t_study
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import close, generator_pair, inject_mir, jax_keys

j_cmp = importlib.import_module("ssar_tpu.metrics.comparison")
j_study = importlib.import_module("ssar_tpu.metrics.study")

FPS = 24
SR = 1024 * FPS


def _track(seconds: float = 1.0):
    """A quiet 220 Hz half and a noisy 330 Hz half with a click every half
    second (tests/test_torch_comparison.py's track, 1 s): the drop at the
    change keeps ``drop_strength`` off a constant, whose normalisation would
    magnify round-off."""
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.RandomState(0)
    half = seconds / 2
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < half, 220.0, 330.0)) / SR)
             + np.where(t < half, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: SR // 2] += 1.0
    return audio


AUDIO = _track()
T = len(AUDIO) // 1024  # 24


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def g_pair(tmp_path_factory):
    return generator_pair(tmp_path_factory.mktemp("g") / "g.npz")


class _Fixed:
    """A predictor that returns one given latent / noise sequence."""

    def __init__(self, latents, noise, to):
        self.latents, self.noise, self.to = latents, noise, to

    def predict(self, audio, sr, palette=None, interp=None):
        return self.to(self.latents), [self.to(n) for n in self.noise]


def _sequence(seed=8, n_ws=6):
    rng = np.random.RandomState(seed)
    lat = np.cumsum(rng.randn(T, n_ws, 512).astype(np.float32) * 0.1, axis=0) + rng.randn(1, n_ws, 512).astype(np.float32)
    return lat.astype(np.float32), [rng.randn(T, s, s).astype(np.float32) for s in (4, 8, 16, 32)]


def test_evaluate_clip_scores_match_jax(g_pair):
    """The same predicted sequence rendered and scored by both packages: the
    128 px video within 1e-4, every record entry within 2e-3 absolute."""
    jG, tG = g_pair
    lat, noise = _sequence()
    want = j_cmp.evaluate_clip(jG, _Fixed(lat, noise, jnp.asarray), AUDIO, SR)
    got = t_cmp.evaluate_clip(tG, _Fixed(lat, noise, torch.as_tensor), AUDIO, SR)
    close(t_cmp._render_lowres(tG, torch.as_tensor(lat), [torch.as_tensor(n) for n in noise]),
          j_cmp._render_lowres(jG, jnp.asarray(lat), [jnp.asarray(n) for n in noise]), 1e-4, "video")
    # 4 of the synthesis's 6 W+ rows: the last row stands for the rest, as JAX's clamped indexing reads it
    close(t_cmp._render_lowres(tG, torch.as_tensor(lat[:, :4]), None),
          j_cmp._render_lowres(jG, jnp.asarray(lat[:, :4]), None), 1e-4, "video from 4 rows")
    assert got.keys() == want.keys() and len(got) == 1 + 9 * 12 + 3
    keys_ = sorted(want)
    assert np.all(np.isfinite([got[k] for k in keys_]))
    close(np.array([got[k] for k in keys_]), np.array([want[k] for k in keys_]), 2e-3, "record", scale=1.0)


def test_random_generator_matches_jax(monkeypatch, g_pair):
    """The same music information in both packages: the same patch, palette
    and sequences; the information is retrieved once per clip."""
    from ssar_tpu_torch.generate import keys

    jax_keys(monkeypatch)
    monkeypatch.setattr(keys, "choice", lambda key, n, p: int(jax.random.choice(
        key, n, p=jnp.asarray(np.asarray(p, np.float32)))))
    jG, tG = g_pair
    calls = inject_mir(monkeypatch, T)
    want_l, want_n = j_cmp.RandomGenerator(jG, seed=6).predict(AUDIO, SR)
    model = t_cmp.RandomGenerator(tG, seed=6)
    got_l, got_n = model.predict(AUDIO, SR)
    model.predict(AUDIO, SR)
    assert len(calls) == 1 and len(model.mir_seconds) == 1
    close(got_l, want_l, 1e-4, "latents")
    assert len(got_n) == len(want_n) == 17
    for layer in (0, 7, 16):   # the 4 px, a 64 px and the 1024 px layer
        close(got_n[layer](5, 6), want_n[layer](5, 6), 1e-4, f"noise window {layer}")


def test_every_predictor_yields_a_record_on_the_cpu(monkeypatch, g_pair, tmp_path):
    """``compare_models`` with all four predictors on the CPU on 1 s (the
    optimizer cut to 2 steps, the random patch on injected music
    information): one finite record each, resumed from the JSONs, the CSV
    written; a predictor that raises is reported and skipped."""
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor

    _, tG = g_pair
    audio = AUDIO
    inject_mir(monkeypatch, len(audio) // 1024)
    palette = np.random.RandomState(11).randn(12, tG.config.n_latent, 512).astype(np.float32)
    models = {"random_patch": t_cmp.RandomGenerator(tG, seed=0),
              "gru": t_cmp.SupervisedSequenceModel(LatentNoiseReactor(np.zeros(59), np.ones(59), palette,
                                                                      backbone="gru", hidden_size=4, num_layers=1)),
              "ssopt": t_cmp.SelfSupervisedOptimization(n_steps=2, gan_config=tG.config, device="cpu"),
              "lucid": t_cmp.LucidSonicBaseline(tG)}
    clips = [("clip0", audio, SR)]
    records = t_cmp.compare_models("study", models, clips, tG, out_dir=str(tmp_path))
    assert [r["model_name"] for r in records] == list(models)
    for r in records:
        assert len(r) == 1 + 9 * 12 + 3 + 3 and all(np.isfinite(v) for k, v in r.items() if k not in
                                                    ("clip", "model_name")), r["model_name"]
    assert sorted(p.name for p in (tmp_path / "study").glob("*.json")) == sorted(f"clip0_{m}.json" for m in models)
    pytest.importorskip("pandas")
    assert (tmp_path / "study.csv").exists()

    class Broken:
        def predict(self, audio, sr):
            raise RuntimeError("boom")

    again = t_cmp.compare_models("study", {**models, "broken": Broken()}, clips, tG, out_dir=str(tmp_path))
    assert again == records   # read back from the JSONs; the broken model left no record
    speed = t_cmp.compare_models("runtimes", {"lucid": models["lucid"]}, clips, tG, out_dir=str(tmp_path),
                                 forward_only=True)
    assert speed[0]["n"] == len(audio) // 1024 and speed[0]["time"] > 0


def test_from_video_dir_and_supplementary_material(g_pair, tmp_path):
    from ssar_tpu_torch.gan.video_io import VideoWriter

    jG, tG = g_pair
    video = t_cmp._render_lowres(tG, *_sequence())[:, :, :64, :64].numpy()
    want = j_cmp.from_video_dir([("a", video, AUDIO, SR)], "vids", out_dir=str(tmp_path / "j"))
    got = t_cmp.from_video_dir([("a", video, AUDIO, SR)], "vids", out_dir=str(tmp_path / "t"), device="cpu")
    keys_ = sorted(k for k in want[0] if k != "clip")
    close(np.array([got[0][k] for k in keys_]), np.array([want[0][k] for k in keys_]), 2e-3, "from_video_dir",
          scale=1.0)
    with VideoWriter(str(tmp_path / "b.mp4"), (64, 64), fps=FPS) as w:
        for frame in video.transpose(0, 2, 3, 1):
            w.write(frame)
    from_file = t_cmp.from_video_dir([("b", str(tmp_path / "b.mp4"), AUDIO, SR)], "vids", out_dir=str(tmp_path / "t"),
                                     downsample=1, device="cpu")
    assert np.isfinite(from_file[0]["correlation"])
    outs = t_cmp.supplementary_material(tG, [("c", AUDIO, SR)], models={"lucid": t_cmp.LucidSonicBaseline(tG)},
                                        out_dir=str(tmp_path / "supp"), duration=1.0, size=32)
    assert [p.rsplit("/", 1)[-1] for p in outs] == ["lucid_c_0.mp4"] and (tmp_path / "supp" / "lucid_c_0.mp4").stat().st_size


# --------------------------------------------------------------------- study --
def test_study_matches_jax(g_pair, tmp_path):
    """The panel on the same full-rank features (the SVD-based measures are
    not unique on rank-deficient ones, ROADMAP C), the tidy records, their
    statistics and the report's files."""
    _, tG = g_pair
    rng = np.random.RandomState(12)
    afeats = {f"a{i}": torch.as_tensor(rng.randn(T, d).astype(np.float32)) for i, d in enumerate((3, 1, 5))}
    vfeats = {f"v{i}": torch.as_tensor(rng.randn(T, d).astype(np.float32)) for i, d in enumerate((4, 2))}
    ja = {k: jnp.asarray(_np(v)) for k, v in afeats.items()}
    jv = {k: jnp.asarray(_np(v)) for k, v in vfeats.items()}
    cases = [(m, {}) for m in t_study.STUDY_MEASURES] + [
        ("procrustes", {"variation_normalized": True}), ("rv2", {"mean_diff_normalized": True})]
    for m, norm in cases:
        for quad in (True, False):
            got = t_study.audiovisual_correlation(afeats, vfeats, m, t_study.CORRELATION_FNS[m], quad, **norm)
            want = j_study.audiovisual_correlation(ja, jv, m, j_study.CORRELATION_FNS[m], quad, **norm)
            if quad:
                assert got.keys() == want.keys()
                got, want = list(got.values()), list(want.values())
            close(np.array(got), np.array(want), 1e-4, f"{m} {quad} {norm}", scale=max(1.0, np.abs(want).max()))

    video = t_cmp._render_lowres(tG, *_sequence())[:, :, :32, :32]
    cache = tmp_path / "cache"
    afe, vfe = t_study.extract_av_features(AUDIO, SR, video, cache_stem=str(cache / "x"), device="cpu")
    again = t_study.extract_av_features(AUDIO, SR, video, cache_stem=str(cache / "x"), device="cpu")
    assert all(torch.equal(afe[k], again[0][k]) for k in afe) and len(afe) == 9 and len(vfe) == 12
    assert {v.shape[0] for v in [*afe.values(), *vfe.values()]} == {T}
    for kind in ("afeats", "vfeats"):   # "y" reads "x"'s cached features: one extraction for the two clips
        (cache / f"y_{kind}.npz").write_bytes((cache / f"x_{kind}.npz").read_bytes())
    pairs = [("x", AUDIO, SR, video), ("y", AUDIO, SR, video)]
    records = t_study.av_feature_study(pairs, measures=("procrustes",), out_dir=str(tmp_path / "report"),
                                       groups={"x": "g1", "y": "g2"}, cache_dir=str(cache), device="cpu")
    assert len(records) == 2 * (9 * 12 + 1) and np.all(np.isfinite([r["value"] for r in records]))
    assert t_study.group_stats(records) == j_study.group_stats(records)
    assert t_study.extrema(records, n=1) == j_study.extrema(records, n=1)
    pytest.importorskip("matplotlib")
    names = {p.name for p in (tmp_path / "report").iterdir()}
    assert {"av_study_procrustes.png", "barplot_concat_corr.png", "group_corr_bars_full.png",
            "group_corr_hists_concat.png", "extrema.txt"} <= names
    assert len(t_study.feature_visualizations(AUDIO, SR, video, str(tmp_path / "viz"), device="cpu")) == 21
