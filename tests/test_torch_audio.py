"""Port audio DSP vs the JAX package, on the CPU, from the same numpy inputs.

The full 59-dim stack is held within the per-group budgets of
docs/PARITY.md (``PARITY_BUDGETS``), with the tuning given explicitly (the
tuning estimate is a histogram argmax, discontinuous in its input); the
tuning estimator is held on its own on clean tones, where it must agree
exactly.  Components are held at rtol 1e-4 of their scale (float32 FFTs and
products summed in another order).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.audio import beat as t_beat
from ssar_tpu_torch.audio import features as t_feat
from ssar_tpu_torch.audio import pitch as t_pitch
from ssar_tpu_torch.audio import spectral as t_spec

j_beat = importlib.import_module("ssar_tpu.audio.beat")
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
