"""Port audio DSP vs the JAX package, on the CPU, from the same numpy inputs.

The full 59-dim stack is held within the per-group budgets of
docs/PARITY.md (``PARITY_BUDGETS``), with the tuning given explicitly (the
tuning estimate is a histogram argmax, discontinuous in its input); the
tuning estimator is held on its own on clean tones, where it must agree
exactly.  Components are held at rtol 1e-4 of their scale (float32 FFTs and
products summed in another order); the named features the optimizer uses, the
grouped-octave CQT, the host beat tracker and the Laplacian segmentation state
their own tolerances.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.audio import beat as t_beat
from ssar_tpu_torch.audio import beat_host as t_bh
from ssar_tpu_torch.audio import constantq as t_cq
from ssar_tpu_torch.audio import features as t_feat
from ssar_tpu_torch.audio import pitch as t_pitch
from ssar_tpu_torch.audio import segment as t_seg
from ssar_tpu_torch.audio import spectral as t_spec

j_beat = importlib.import_module("ssar_tpu.audio.beat")
j_bh = importlib.import_module("ssar_tpu.audio.beat_host")
j_cq = importlib.import_module("ssar_tpu.audio.constantq")
j_seg = importlib.import_module("ssar_tpu.audio.segment")
j_feat = importlib.import_module("ssar_tpu.audio.features")
j_pitch = importlib.import_module("ssar_tpu.audio.pitch")
j_spec = importlib.import_module("ssar_tpu.audio.spectral")

FPS = 24
SR = 1024 * FPS


def _track(sr, seconds, seed=0):
    """Arpeggio + noise + clicks: tonal content for chroma, transients for onsets."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.RandomState(seed)
    notes = 220.0 * 2 ** (np.array([0, 4, 7, 12]) / 12)
    f = notes[(t * 4).astype(int) % 4]
    audio = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / sr) + 0.05 * rng.randn(len(t))
    audio[:: sr // 2] += 1.0
    return audio.astype(np.float32)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * (np.abs(want).max() + 1e-30))


def test_audio2features_within_parity_budgets():
    sr, tuning = 44100, 0.13  # resampled to 1024 * FPS inside
    audio = _track(sr, 3.0)
    want = np.asarray(j_feat.audio2features(jnp.asarray(audio), sr, FPS, tuning=tuning))
    got = t_feat.audio2features(audio, sr, FPS, tuning=tuning, device="cpu").numpy()
    assert got.shape == want.shape == (72, t_feat.N_FEATURES)
    for group, (cols, budget) in t_feat.PARITY_BUDGETS.items():
        err = np.abs(got[:, cols] - want[:, cols]).max()
        assert err <= budget, f"{group}: {err:.3g} > {budget}"


@pytest.mark.parametrize("offset", [0.0, 0.2, -0.3])
def test_estimate_tuning_device_clean_tone(offset):
    t = np.arange(4 * SR) / SR
    f0 = 440.0 * 2 ** (offset / 36)
    tone = (0.5 * np.sin(2 * np.pi * f0 * t) + 0.25 * np.sin(2 * np.pi * 1.5 * f0 * t)).astype(np.float32)
    want = float(j_pitch.estimate_tuning_device(jnp.asarray(tone), SR, bins_per_octave=36))
    got = float(t_pitch.estimate_tuning_device(torch.as_tensor(tone), SR, bins_per_octave=36))
    assert abs(got - want) < 1e-6  # the same histogram bin (grid values differ by float32 rounding)


def test_stft_hpss_istft():
    audio = _track(SR, 2.0)
    S_j = j_spec.stft(jnp.asarray(audio))
    S_t = t_spec.stft(torch.as_tensor(audio))
    _close(S_t.abs(), jnp.abs(S_j))
    H_j, P_j = j_spec.hpss(S_j, margin=8.0)
    H_t, P_t = t_spec.hpss(S_t, margin=8.0)
    _close(H_t.abs(), jnp.abs(H_j))
    _close(P_t.abs(), jnp.abs(P_j))
    _close(t_spec.istft(H_t, length=len(audio)), j_spec.istft(H_j, length=len(audio)))


@pytest.mark.parametrize("pad_mode", ["constant", "edge"])
def test_spectral_front_end_pad_modes_match_jax(pad_mode):
    """``pad_mode`` of ``frame_signal``, ``stft``, ``spectrogram`` and
    ``melspectrogram`` (with ``window`` and ``center``) against the JAX
    package's: the frames exactly (a pad and a copy), the rest at rtol 1e-4
    of their scale; the default stays reflect."""
    audio = _track(SR, 0.5)
    y_j, y_t = jnp.asarray(audio), torch.as_tensor(audio)
    np.testing.assert_array_equal(t_spec.frame_signal(y_t, 2048, 1024, pad_mode=pad_mode).numpy(),
                                  np.asarray(j_spec.frame_signal(y_j, 2048, 1024, pad_mode=pad_mode)))
    _close(t_spec.stft(y_t, pad_mode=pad_mode).abs(), jnp.abs(j_spec.stft(y_j, pad_mode=pad_mode)))
    _close(t_spec.spectrogram(y_t, n_fft=1024, hop_length=256, power=2.0, pad_mode=pad_mode),
           j_spec.spectrogram(y_j, n_fft=1024, hop_length=256, power=2.0, pad_mode=pad_mode))
    for window, center in ((None, True), ("hann", False)):
        _close(t_spec.melspectrogram(y_t, SR, window=window, center=center, pad_mode=pad_mode),
               j_spec.melspectrogram(y_j, SR, window=window, center=center, pad_mode=pad_mode))
    assert not torch.equal(t_spec.stft(y_t, pad_mode=pad_mode), t_spec.stft(y_t))
    np.testing.assert_array_equal(t_spec.frame_signal(y_t, 2048, 1024).numpy(),
                                  np.asarray(j_spec.frame_signal(y_j, 2048, 1024)))


def test_cens_device_tuned():
    """The recursive CQT on the half-bin grid, interpolated at a device tuning."""
    audio = _track(SR, 2.0)
    tau = 0.17
    _close(t_spec.chroma_cens(torch.as_tensor(audio), SR, tuning=torch.tensor(tau)),
           j_spec.chroma_cens(jnp.asarray(audio), SR, tuning=jnp.asarray(tau)))


def test_onsets_and_plp():
    audio = _track(SR, 3.0)
    bands = np.stack([audio, 0.5 * audio[::-1]])
    _close(t_beat.onset_strength_multi(torch.as_tensor(bands), SR),
           j_beat.onset_strength_multi(jnp.asarray(bands), SR))
    _close(t_beat.plp(torch.as_tensor(audio), SR), j_beat.plp(jnp.asarray(audio), SR), rtol=1e-3)


# ---------------------------------- the optimizer's feature entry points --
@pytest.mark.parametrize("name,rtol", [("harmonic", 1e-4), ("percussive", 1e-4), ("onsets", 1e-4), ("rms", 1e-5),
                                       ("drop_strength", 1e-4), ("mfcc", 1e-4), ("spectral_contrast", 1e-3),
                                       ("pulse", 1e-3)])
def test_named_features_match_jax(name, rtol):
    """Each named feature with the JAX signature, (T, C) at one row per frame."""
    audio = _track(SR, 3.0)
    args = () if name in ("harmonic", "percussive") else (SR,)
    want = np.asarray(getattr(j_feat, name)(jnp.asarray(audio), *args))
    got = getattr(t_feat, name)(torch.as_tensor(audio), *args)
    assert tuple(got.shape) == want.shape
    _close(got, want, rtol)


# -------------------------------------- the reference's signatures (C1) --
@pytest.mark.parametrize("name,rtol", [("chromagram", 1e-3), ("tonnetz", 1e-3), ("mfcc", 1e-4),
                                       ("spectral_contrast", 1e-3), ("spectral_flatness", 1e-5), ("rms", 1e-5),
                                       ("drop_strength", 1e-4), ("onsets", 1e-4)])
def test_named_features_called_as_mir_calls_them(name, rtol):
    """Every feature of the random-patch system's table
    (``ssar_tpu/generate/mir.py:AFEATFNS``) called as it calls them,
    ``fn(audio, sr)``: the same shape as JAX's and the values at the stated
    rtol of their scale (spectral flatness at 1e-5, (T, 1)).  The track makes
    the tuning estimate's argmax win by a wide margin."""
    audio = _two_halves(SR, 3.0)
    want = np.asarray(getattr(j_feat, name)(jnp.asarray(audio), SR))
    got = getattr(t_feat, name)(torch.as_tensor(audio), SR)
    assert tuple(got.shape) == want.shape and want.shape[0] == 72
    _close(got, want, rtol)


def test_fourier_tempogram_takes_sr_positionally():
    """``fourier_tempogram(env, sr)``: `sr` is not the window length."""
    env = np.asarray(j_beat.onset_strength(jnp.asarray(_track(SR, 3.0)), SR))
    want = np.asarray(j_beat.fourier_tempogram(jnp.asarray(env), SR))
    got = t_beat.fourier_tempogram(torch.as_tensor(env), SR)
    assert tuple(got.shape) == want.shape == (513, 73)
    _close(got, want, 1e-4)


def test_spectral_contrast_linear_matches_jax():
    audio = _track(SR, 3.0)
    want = np.asarray(j_feat.spectral_contrast(jnp.asarray(audio), SR, linear=True))
    got = t_feat.spectral_contrast(torch.as_tensor(audio), SR, linear=True)
    assert tuple(got.shape) == want.shape == (72, 7)
    _close(got, want, 1e-4)


def test_cqt_method_reaches_chroma_and_the_stack():
    """``chromagram`` / ``tonnetz(method="direct")`` and ``audio2features(
    cqt_method="direct")`` take the grouped-octave CQT in both packages: the
    chroma at 1e-3 of its scale, the stack within the parity budgets, and
    the direct stack differs from the recursive one."""
    audio = _track(SR, 3.0)
    for fn in ("chromagram", "tonnetz"):
        want = np.asarray(getattr(j_feat, fn)(jnp.asarray(audio), SR, tuning=0.13, method="direct"))
        _close(getattr(t_feat, fn)(torch.as_tensor(audio), SR, tuning=0.13, method="direct"), want, 1e-3)
    want = np.asarray(j_feat.audio2features(jnp.asarray(audio), SR, FPS, tuning=0.13, cqt_method="direct"))
    got = t_feat.audio2features(audio, SR, FPS, tuning=0.13, cqt_method="direct", device="cpu").numpy()
    for group, (cols, budget) in t_feat.PARITY_BUDGETS.items():
        err = np.abs(got[:, cols] - want[:, cols]).max()
        assert err <= budget, f"{group}: {err:.3g} > {budget}"
    recursive = t_feat.audio2features(audio, SR, FPS, tuning=0.13, device="cpu").numpy()
    assert np.abs(recursive[:, 20:38] - got[:, 20:38]).max() > 1e-3


def _two_halves(sr, seconds):
    """A quiet-noise 220 Hz half and a noisy 330 Hz half with a click every
    half second: the tuning histogram's top bin holds about twice the next
    one's candidates, and the CQT segmentation's clusters do not tie, so both
    packages make the same discrete choices whatever the round-off."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.RandomState(0)
    first = t < seconds / 2
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(first, 220.0, 330.0)) / sr)
             + np.where(first, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    return audio


@pytest.mark.parametrize("tuning", [0.13, None])
def test_chromagram_and_tonnetz_match_jax(tuning):
    """With ``tuning=None`` both packages estimate the deviation on the device
    from the harmonic signal (on a track where the histogram's argmax has a
    wide margin)."""
    audio = _track(SR, 3.0) if tuning is not None else _two_halves(SR, 3.0)
    want = np.asarray(j_feat.chromagram(jnp.asarray(audio), SR, tuning=tuning))
    got = t_feat.chromagram(torch.as_tensor(audio), SR, tuning=tuning)
    assert tuple(got.shape) == want.shape == (72, 12)
    _close(got, want, 1e-3)
    want_t = np.asarray(j_feat.tonnetz(jnp.asarray(audio), SR, tuning=tuning))
    _close(t_feat.tonnetz(torch.as_tensor(audio), SR, tuning=tuning), want_t, 1e-3)
    _close(t_feat.tonnetz(None, SR, chroma=got), want_t, 1e-3)


@pytest.mark.parametrize("kwargs", [dict(n_bins=252, bins_per_octave=36), dict(n_bins=84, bins_per_octave=12),
                                    dict(n_bins=30, bins_per_octave=12, tuning=0.2)])
def test_cqt_direct_matches_jax(kwargs):
    """The grouped-octave CQT (the default method) against JAX's, and against
    the recursive chain within resampling error (5 % of the largest bin)."""
    audio = _track(SR, 2.0)
    want = np.asarray(j_cq.cqt(jnp.asarray(audio), SR, **kwargs))
    got = t_cq.cqt(torch.as_tensor(audio), SR, **kwargs)
    assert tuple(got.shape) == want.shape == (kwargs["n_bins"], 48) and got.dtype == torch.complex64
    _close(got, want, 1e-4)
    recursive = t_cq.cqt(torch.as_tensor(audio), SR, method="recursive", **kwargs)
    if kwargs["n_bins"] % kwargs["bins_per_octave"] == 0:
        assert float((got.abs() - recursive.abs()).abs().max()) < 0.05 * float(recursive.abs().max())
    _close(recursive, np.asarray(j_cq.cqt(jnp.asarray(audio), SR, method="recursive", **kwargs)), 1e-4)


def test_vqt_direct_matches_jax_and_rejects_unknown_method():
    audio = _track(SR, 2.0)
    want = np.asarray(j_cq.vqt(jnp.asarray(audio), SR, n_bins=48, bins_per_octave=12))
    _close(t_cq.vqt(torch.as_tensor(audio), SR, n_bins=48, bins_per_octave=12), want, 1e-4)
    with pytest.raises(ValueError):
        t_cq.vqt(torch.as_tensor(audio), SR, method="fft")


def test_beat_host_matches_jax():
    """numpy on both sides: the same floats."""
    audio = _track(SR, 6.0)
    env = np.asarray(j_beat.onset_strength(jnp.asarray(audio), SR))
    assert t_bh.estimate_tempo(env, SR) == j_bh.estimate_tempo(env, SR)
    np.testing.assert_array_equal(t_bh.tempo_frequencies(32, SR, 1024), j_bh.tempo_frequencies(32, SR, 1024))
    for kw in ({}, {"trim": True}, {"bpm": 100.0}):
        bpm_t, beats_t = t_bh.beat_track(env, SR, **kw)
        bpm_j, beats_j = j_bh.beat_track(env, SR, **kw)
        assert bpm_t == bpm_j and len(beats_t) > 3
        np.testing.assert_array_equal(beats_t, beats_j)


# ------------------------------------------------------------ segmentation --
def _sectioned(T=96, C=5, sections=4, seed=0):
    rng = np.random.RandomState(seed)
    sec = np.repeat(rng.randn(sections, C) * 2, T // sections, axis=0)
    return (sec + 0.1 * rng.randn(T, C)).astype(np.float32)


def test_recurrence_matrix_shear_and_timelag_filter_match_jax():
    data = _sectioned()[::4]
    for kw in (dict(width=3, sym=True), dict(), dict(k=5, width=2, bandwidth=1.5)):
        _close(t_seg.recurrence_matrix(torch.as_tensor(data), **kw), j_seg.recurrence_matrix(jnp.asarray(data), **kw),
               1e-5)
    _close(t_seg.distance_matrix(torch.as_tensor(data)), j_seg.distance_matrix(jnp.asarray(data)), 1e-5)
    R = np.asarray(j_seg.recurrence_matrix(jnp.asarray(data), width=3, sym=True))
    for factor in (-1, 1, 2):
        np.testing.assert_array_equal(t_seg.shear(torch.as_tensor(R), factor).numpy(),
                                      np.asarray(j_seg.shear(jnp.asarray(R), factor)))
    np.testing.assert_array_equal(t_seg.timelag_median_filter(torch.as_tensor(R)).numpy(),
                                  np.asarray(j_seg.timelag_median_filter(jnp.asarray(R))))


def test_kmeans_matches_jax():
    rng = np.random.RandomState(3)
    data = (np.repeat(rng.randn(3, 4), 8, axis=0) + 0.1 * rng.randn(24, 4)).astype(np.float32)
    unit = data / np.linalg.norm(data, axis=1, keepdims=True)
    np.testing.assert_allclose(t_seg._kmeans_pp_init_torch(torch.as_tensor(unit), 3).numpy(),
                               t_seg._kmeans_pp_init(unit, 3), atol=1e-6)
    np.testing.assert_array_equal(t_seg._kmeans_pp_init(unit, 3), j_seg._kmeans_pp_init(unit, 3))
    for got, want in zip(t_seg.differentiable_k_means(torch.as_tensor(data), 3),
                         j_seg.differentiable_k_means(jnp.asarray(data), 3)):
        _close(got, want, 1e-4)


def test_laplacian_segmentation_matches_jax():
    """Values within 1e-4 and every frame's label equal on a sectioned input;
    the gradient of a weighted sum of the assignments within 1e-3 of its
    largest entry (eigh's and 100 k-means iterations' backward in float32, and
    the median's first-equal-tap rule against JAX's sort gradient: the tied
    taps are structural zeros whose upstream derivative is 0)."""
    env = _sectioned()
    beats = list(range(4, 96, 4))
    ks = (2, 4)
    segs_j = j_seg.laplacian_segmentation(jnp.asarray(env), beats, ks=ks)
    et = torch.as_tensor(env).requires_grad_()
    segs_t = t_seg.laplacian_segmentation(et, beats, ks=ks)
    for got, want, k in zip(segs_t, segs_j, ks):
        assert tuple(got.shape) == (96, k)
        _close(got.detach(), want, 1e-4)
        np.testing.assert_array_equal(got.detach().numpy().argmax(1), np.asarray(want).argmax(1))

    def weighted(segs, xp):
        return sum((s * xp.arange(s.shape[1])).sum() for s in segs)

    want_g = np.asarray(jax.grad(lambda e: weighted(j_seg.laplacian_segmentation(e, beats, ks=ks), jnp))(
        jnp.asarray(env)))
    weighted(segs_t, torch).backward()
    _close(et.grad, want_g, 1e-3)
    assert float(np.abs(want_g).max()) > 1.0

    # fewer beat-synchronous frames than clusters: columns are padded
    short = t_seg.laplacian_segmentation(torch.as_tensor(env[:24]), [4, 8, 12, 16, 20], ks=(2, 8))
    want_short = j_seg.laplacian_segmentation(jnp.asarray(env[:24]), [4, 8, 12, 16, 20], ks=(2, 8))
    assert tuple(short[1].shape) == (24, 8) and float(short[1][:, 6:].abs().max()) == 0.0
    _close(short[1], want_short[1], 1e-4)


def test_laplacian_segmentation_np_matches_jax():
    """The host version is numpy float64 in both packages: the same floats.
    Against the differentiable version labels agree on most frames after
    alignment (the two read different halves of a non-symmetric Laplacian)."""
    from scipy.optimize import linear_sum_assignment

    rng = np.random.RandomState(0)
    T, C = 240, 12
    env = (np.repeat(rng.rand(6, C), 40, axis=0) + 0.05 * rng.rand(T, C)).astype(np.float32)
    beats = list(range(7, T, 8))
    ks = (2, 4, 6)
    segs_np = t_seg.laplacian_segmentation_np(env, beats, ks=ks)
    for got, want in zip(segs_np, j_seg.laplacian_segmentation_np(env, beats, ks=ks)):
        np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_array_equal(t_seg._np_median_filter(env, 9, 0), j_seg._np_median_filter(env, 9, 0))
    segs_t = t_seg.laplacian_segmentation(torch.as_tensor(env), beats, ks=ks)
    for s_np, s_t, k in zip(segs_np, segs_t, ks):
        conf = np.zeros((k, k))
        for i, j in zip(np.argmax(s_np, 1), s_t.numpy().argmax(1)):
            conf[i, j] += 1
        rows, cols = linear_sum_assignment(-conf)
        assert conf[rows, cols].sum() / T > 0.85, k


def test_laplacian_segmentation_rosa_matches_jax():
    """Hard labels of the CQT-driven segmentation: equal on a track in two
    clearly different halves (the labels are an argmax over soft assignments
    and survive 1e-3 dB of noise on its CQT)."""
    sr = 1024 * 12
    audio = _two_halves(sr, 4.0)
    want = j_seg.laplacian_segmentation_rosa(audio, sr, 48, ks=(2, 4))
    got = t_seg.laplacian_segmentation_rosa(audio, sr, 48, ks=(2, 4), device="cpu")
    assert got.shape == want.shape == (48, 2) and len(np.unique(want[:, 0])) == 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_seg.laplacian_segmentation_rosa(torch.as_tensor(audio), sr, 48, ks=(2, 4)), want)
