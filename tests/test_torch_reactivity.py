"""The port's audio-reactivity evaluation (``metrics/correlation.py``,
``rhythmic.py``, ``chroma.py``, ``sectional.py`` and the onset helpers of
``audio/processing.py``) against the JAX package's, small, on the CPU.

Both packages take the same numpy inputs made from a seed.  Tolerances:
- the correlation zoo within 1e-5 absolute, and 1e-4 for the measures that
  go through an SVD, a QR, an eigen-decomposition or a pseudo-inverse
  (``SVD_BASED``), on full-rank inputs with distinct canonical correlations
  (on rank-deficient or near-degenerate inputs the singular bases are not
  unique, and ``pwcca`` and ``r3`` moved by 1e-3 between the two LAPACKs);
  ``sgw`` with JAX's projections injected into ``generate/keys.py``;
- ranks, ``xi`` and ``foci_codependence`` on tied inputs within 1e-6 (the
  same stable orders); soft ranks within 1e-5 up to rank 30, and within
  1e-6 relative up to rank 80 (float32 sums of 80 sigmoids);
- ``rhythmic_reactivity``, ``chromatic_reactivity`` (with and without the
  soft-rank spearman) and ``evaluate_reactivity`` within 1e-4, on a track on
  which both packages' tuning estimates agree (the estimate flips on float32
  round-off, ROADMAP C; on a track where they differ by one grid step the
  chroma moved by 5.6e-3);
- ``evaluate_file`` on an mp4 written by the port's ``VideoWriter``: the same
  decoded frames and the same scores within 1e-4;
- the host study (``dtw_distance``, ``metric_sensitivity_study``) within
  1e-5 relative, with the same ``RandomState`` permutations.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.audio import processing as t_proc
from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.metrics import chroma as t_chroma
from ssar_tpu_torch.metrics import correlation as t_corr
from ssar_tpu_torch.metrics import rhythmic as t_rhy
from ssar_tpu_torch.metrics import sectional as t_sec

j_proc = importlib.import_module("ssar_tpu.audio.processing")
j_corr = importlib.import_module("ssar_tpu.metrics.correlation")
j_rhy = importlib.import_module("ssar_tpu.metrics.rhythmic")
j_chroma = importlib.import_module("ssar_tpu.metrics.chroma")
j_sec = importlib.import_module("ssar_tpu.metrics.sectional")

FPS = 24
SR = 1024 * FPS
SVD_BASED = {"svcca", "pwcca", "smi", "procrustes", "coxhead", "r2", "r3", "r4", "rG"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _track(seconds: float = 4.0):
    """A quiet 220 Hz half and a noisy 330 Hz half with a click every half
    second (tests/test_torch_optimize.py's track): both packages estimate
    the same tuning on its harmonic part."""
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.RandomState(0)
    half = seconds / 2
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < half, 220.0, 330.0)) / SR)
             + np.where(t < half, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: SR // 2] += 1.0
    return audio


AUDIO = _track()
T = len(AUDIO) // 1024  # 96


def _video(seed: int = 1, size: int = 16):
    """(T, 3, size, size): a colour that changes with the track's halves,
    a flash on every click, and noise."""
    rng = np.random.RandomState(seed)
    v = np.empty((T, 3, size, size), np.float32)
    v[: T // 2] = np.array([0.7, 0.3, 0.2], np.float32)[:, None, None]
    v[T // 2 :] = np.array([0.2, 0.4, 0.8], np.float32)[:, None, None]
    v[:: FPS // 2] += 0.25
    v += 0.1 * rng.rand(*v.shape).astype(np.float32)
    return np.clip(v, 0.0, 1.0)


def _pairs():
    """Full-rank (T, 5) inputs sharing three directions at distinct noise
    levels, and a (T, 3) input of another width."""
    rng = np.random.RandomState(3)
    base = rng.randn(64, 3)
    x = np.hstack([base, rng.randn(64, 2) * 0.3]).astype(np.float32)
    y = np.hstack([base @ rng.randn(3, 3) + rng.randn(64, 3) * np.array([0.1, 0.4, 1.0]),
                   rng.randn(64, 2) * 0.5]).astype(np.float32)
    z = (base[:, :2] @ rng.randn(2, 3) + 0.5 * rng.randn(64, 3)).astype(np.float32)
    return x, y, z


# ------------------------------------------------------ processing helpers --
def test_onset_helpers_match_jax():
    rng = np.random.RandomState(0)
    spec = rng.rand(40, 8).astype(np.float32)
    flux = j_proc.spectral_flux(jnp.asarray(spec))
    _close(t_proc.spectral_flux(_t(spec)), flux, 1e-7)
    _close(t_proc.onset_envelope(_t(np.asarray(flux))), j_proc.onset_envelope(flux), 1e-6)
    arr = rng.randn(7, 30, 11).astype(np.float32)
    _close(t_proc.standardize(_t(arr)), j_proc.standardize(jnp.asarray(arr)), 1e-6)
    slices = [slice(0, 4), 6, slice(9, 20)]
    for pad in (False, True):
        want = j_proc.sync_agg(jnp.asarray(spec), slices, axis=0, pad_slice=pad)
        _close(t_proc.sync_agg(_t(spec), slices, axis=0, pad_slice=pad), want, 1e-6)
    want = j_proc.sync_agg(jnp.asarray(spec), [slice(0, 3), slice(3, 8)], aggregate=jnp.max, axis=1)
    _close(t_proc.sync_agg(_t(spec), [slice(0, 3), slice(3, 8)], aggregate=torch.amax, axis=1), want, 0.0)


# ----------------------------------------------------------- correlation --
@pytest.mark.parametrize("name", sorted(j_corr.CORRELATION_FNS))
def test_correlation_fns_match_jax(name):
    x, y, z = _pairs()
    for a, b in ((x, y), (x, z)):
        want = float(j_corr.CORRELATION_FNS[name](jnp.asarray(a), jnp.asarray(b)))
        got = float(t_corr.CORRELATION_FNS[name](_t(a), _t(b)))
        assert abs(got - want) <= (1e-4 if name in SVD_BASED else 1e-5), (name, a.shape, b.shape, got, want)


@pytest.mark.parametrize("name", sorted(j_corr.CORRELATION_FNS_EQUAL_WIDTH))
def test_equal_width_correlation_fns_match_jax(name):
    x, y, _ = _pairs()
    want = float(j_corr.CORRELATION_FNS_EQUAL_WIDTH[name](jnp.asarray(x), jnp.asarray(y)))
    got = float(t_corr.CORRELATION_FNS_EQUAL_WIDTH[name](_t(x), _t(y)))
    assert abs(got - want) <= (1e-4 if name in SVD_BASED else 1e-5), (name, got, want)


def test_rg_with_components_and_smi_with_k_match_jax():
    x, y, _ = _pairs()
    _close(t_corr.rG(_t(x), _t(y), n_components=2), j_corr.rG(jnp.asarray(x), jnp.asarray(y), n_components=2), 1e-4)
    _close(t_corr.smi(_t(x), _t(y), k=2), j_corr.smi(jnp.asarray(x), jnp.asarray(y), k=2), 1e-4)
    _close(t_corr.spearman(_t(x), _t(y), differentiable=True),
           j_corr.spearman(jnp.asarray(x), jnp.asarray(y), differentiable=True), 1e-5)


def test_ranks_xi_and_foci_on_ties_match_jax():
    """Quantised inputs with many ties: the stable orders of the reference."""
    rng = np.random.RandomState(5)
    a = np.round(rng.randn(80) * 2).astype(np.float32)
    b = np.round(a**2 / 3 + rng.randn(80)).astype(np.float32)
    X = np.round(rng.randn(80, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_corr.hard_rank(_t(a)).numpy(), np.asarray(j_corr.hard_rank(jnp.asarray(a))))
    _close(t_corr.soft_rank(_t(a[:30]), 0.5), j_corr.soft_rank(jnp.asarray(a[:30]), 0.5), 1e-5)
    # ranks up to 80 are float32 sums of 80 sigmoids, where an ulp is 7.6e-6: held relative there
    _close(t_corr.soft_rank(_t(a), 0.5), j_corr.soft_rank(jnp.asarray(a), 0.5), 0.0, rtol=1e-6)
    _close(t_corr.xi(_t(a), _t(b)), j_corr.xi(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    _close(t_corr.xi(_t(b), _t(a)), j_corr.xi(jnp.asarray(b), jnp.asarray(a)), 1e-6)
    _close(t_corr.foci_codependence(_t(b), _t(X)), j_corr.foci_codependence(jnp.asarray(b), jnp.asarray(X)), 1e-6)
    x, y, _ = _pairs()
    _close(t_corr.foci_codependence(_t(y[:, 0]), _t(x)),
           j_corr.foci_codependence(jnp.asarray(y[:, 0]), jnp.asarray(x)), 1e-6)


def test_sgw_with_jax_projections_matches_jax(monkeypatch):
    monkeypatch.setattr(keys, "PRNGKey", jax.random.PRNGKey)
    monkeypatch.setattr(keys, "split", lambda key, num=2: tuple(jax.random.split(key, num)))
    monkeypatch.setattr(keys, "normal", lambda key, shape=(), device=None:
                        torch.as_tensor(np.array(jax.random.normal(key, tuple(shape))), device=device))
    x, _, z = _pairs()
    want = float(j_corr.sgw(jnp.asarray(x), jnp.asarray(z), n_proj=50))
    got = float(t_corr.sgw(_t(x), _t(z), n_proj=50))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)
    want = float(j_corr.sgw(jnp.asarray(x), jnp.asarray(x), key=jax.random.PRNGKey(3), n_proj=20))
    assert abs(float(t_corr.sgw(_t(x), _t(x), key=jax.random.PRNGKey(3), n_proj=20)) - want) <= 1e-5


# ------------------------------------------------------------- rhythmic --
def test_rhythmic_reactivity_matches_jax():
    """The reference's constructed clips (tests/test_metrics_video.py): a
    flash on each onset of a click track scores above a static clip, on both."""
    rng = np.random.RandomState(42)
    sr, n = 24576, 48
    audio = 0.05 * rng.randn(sr * 2).astype(np.float32)
    audio[:: sr // 4] += 1.5
    reactive = np.zeros((n, 3, 16, 16), np.float32)
    reactive[::6] = 1.0
    static = np.full((n, 3, 16, 16), 0.5, np.float32) + 0.01 * rng.rand(n, 3, 16, 16).astype(np.float32)
    scores = []
    for video in (reactive, static):
        want = float(j_rhy.rhythmic_reactivity(jnp.asarray(audio), sr, jnp.asarray(video), FPS))
        got = float(t_rhy.rhythmic_reactivity(audio, sr, video, FPS, device="cpu"))
        assert abs(got - want) <= 1e-4, (got, want)
        scores.append(got)
    assert scores[0] > scores[1]


def test_rhythmic_reactivity_resamples_stereo_like_jax():
    audio = np.stack([AUDIO, 0.5 * AUDIO])[:, : 44100 * 2]
    video = _video()[:48]
    want = float(j_rhy.rhythmic_reactivity(jnp.asarray(audio), 44100, jnp.asarray(video), FPS))
    got = float(t_rhy.rhythmic_reactivity(audio, 44100, video, FPS, device="cpu"))
    assert abs(got - want) <= 1e-4, (got, want)


def test_postprocess_and_absdiff_env_match_jax():
    rng = np.random.RandomState(2)
    env = np.abs(rng.randn(96)).astype(np.float32)
    _close(t_rhy._postprocess(_t(env), FPS), j_rhy._postprocess(jnp.asarray(env), FPS), 1e-6)
    video = _video()
    _close(t_rhy.video_absdiff_env(_t(video)), j_rhy.video_absdiff_env(jnp.asarray(video)), 0.0, rtol=1e-5)


def test_dtw_and_metric_sensitivity_study_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    a, b = rng.rand(30).astype(np.float32), rng.rand(25).astype(np.float32)
    assert t_rhy.dtw_distance(a, b) == pytest.approx(j_rhy.dtw_distance(a, b), rel=1e-12)
    audio_env = rng.rand(24).astype(np.float32)
    env_sets = {"noise": rng.rand(2, 30).astype(np.float32), "echo": np.stack([audio_env, audio_env[::-1]])}
    want = j_rhy.metric_sensitivity_study(audio_env, env_sets, strengths=3, seed=0)
    got = t_rhy.metric_sensitivity_study(audio_env, env_sets, strengths=3, seed=0, out_dir=str(tmp_path),
                                         device="cpu")
    assert len(got) == len(want) == 5 * 4 * 2 * 3
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("transform", "metric", "envelope_set")} == \
            {k: w[k] for k in ("transform", "metric", "envelope_set")}
        assert g["strength"] == pytest.approx(w["strength"], rel=1e-12)
        for k in ("mean", "std"):
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-6), (g, w)


# --------------------------------------------------------------- chroma --
def test_nn_filter_cosine_median_on_tied_frames_matches_jax():
    """Repeated (tied) chroma frames make whole rows of the similarity equal:
    the same k neighbours (the lower frame first), and the median of the
    even k = 2 ceil(sqrt(T)) neighbours as the mean of the two middle ones."""
    rng = np.random.RandomState(6)
    frames = rng.rand(12, 5).astype(np.float32)
    S = np.repeat(frames, [7, 3, 9, 5, 6], axis=1)[:, rng.permutation(30)]
    S[:, 4] = 0.0  # a silent frame
    want = np.asarray(j_chroma.nn_filter_cosine_median(jnp.asarray(S)))
    got = t_chroma.nn_filter_cosine_median(_t(S))
    _close(got, want, 1e-7)
    k = 2 * int(np.ceil(np.sqrt(30)))
    assert k % 2 == 0
    neigh = _t(rng.rand(4, k, 3).astype(np.float32))
    assert not torch.equal(t_chroma._median_midpoint(neigh, 1), neigh.median(dim=1).values)
    _close(t_chroma._median_midpoint(neigh, 1), jnp.median(jnp.asarray(neigh.numpy()), axis=1), 0.0)


@pytest.mark.parametrize("spearman", [False, True])
def test_chromatic_reactivity_matches_jax(spearman):
    video = _video()
    want = float(j_chroma.chromatic_reactivity(jnp.asarray(AUDIO), SR, jnp.asarray(video), FPS, spearman=spearman))
    got = float(t_chroma.chromatic_reactivity(AUDIO, SR, video, FPS, spearman=spearman, device="cpu"))
    assert abs(got - want) <= 1e-4, (got, want)
    assert -1.0 <= got <= 1.0


def test_frame_histograms_and_corrcoef_match_jax():
    video = _video()
    video[3] = 0.5  # a constant frame: every value in the first bin
    np.testing.assert_array_equal(t_chroma._frame_histograms(_t(video)).numpy(),
                                  np.asarray(j_chroma._frame_histograms(jnp.asarray(video))))
    rng = np.random.RandomState(7)
    a, b = rng.rand(50).astype(np.float32), rng.rand(50).astype(np.float32)
    for sp in (False, True):
        _close(t_chroma.correlation(_t(a), _t(b), spearman=sp),
               j_chroma.correlation(jnp.asarray(a), jnp.asarray(b), spearman=sp), 1e-6)


# ----------------------------------------------------------- evaluation --
def test_evaluate_reactivity_matches_jax():
    video = _video()
    video[10] = 0.0  # a constant (black) frame
    want = j_sec.evaluate_reactivity(AUDIO, SR, video, FPS)
    got = t_sec.evaluate_reactivity(AUDIO, SR, video, FPS, device="cpu")
    assert set(got) == {"rhythmic", "chromatic"}
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert 0.0 <= got["rhythmic"] <= 1.0 and -1.0 <= got["chromatic"] <= 1.0


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_prepare_frames_is_cv2_inter_area(d):
    import cv2

    rng = np.random.RandomState(d)
    frames = rng.randint(0, 256, (70, 24, 36, 3)).astype(np.uint8)
    want = np.stack([f if d == 1 else cv2.resize(f, (36 // d, 24 // d), interpolation=cv2.INTER_AREA)
                     for f in frames]).astype(np.float32) / 255.0
    got = t_sec.prepare_frames(frames, d, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))


def test_evaluate_file_matches_jax(tmp_path):
    from ssar_tpu_torch.gan.video_io import VideoWriter

    big = np.repeat(np.repeat(_video(size=16), 4, axis=2), 4, axis=3)  # 64 px
    big = big + 0.05 * np.random.RandomState(8).rand(*big.shape).astype(np.float32)
    path = tmp_path / "clip.mp4"
    with VideoWriter(str(path), (64, 64), fps=FPS) as w:
        for f in big:
            w.write((np.clip(f.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8))
    want_v, want_fps = j_sec.load_video(str(path), 4)
    got_v, got_fps = t_sec.load_video(str(path), 4, device="cpu")
    assert got_fps == want_fps == FPS
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    want = j_sec.evaluate_file(str(path), AUDIO, SR)
    got = t_sec.evaluate_file(str(path), AUDIO, SR, device="cpu")
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_evaluation_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sec.evaluate_reactivity(AUDIO, SR, _video(), FPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rhy.rhythmic_reactivity(AUDIO, SR, _video(), FPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sec.prepare_frames(np.zeros((2, 8, 8, 3), np.uint8), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rhy.metric_sensitivity_study(np.zeros(8, np.float32), {"zeros": np.zeros((1, 8), np.float32)})
