"""The port's long-form features (``parallel/features_sp.py``) against the JAX
package's, on the CPU, from the same numpy track.

The chunk plan is integer arithmetic and must be equal.  The features are
held within the per-group budgets of docs/PARITY.md (``PARITY_BUDGETS``), as
the whole-track stack is; with ``tuning=None`` both packages estimate the
tuning on the host from the first 4 s, on a track whose histogram has a wide
margin, and must agree on it exactly.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.audio import features as t_feat
from ssar_tpu_torch.ops import median_cuda
from ssar_tpu_torch.parallel import features_sp as t_sp

j_sp = importlib.import_module("ssar_tpu.parallel.features_sp")
j_pitch = importlib.import_module("ssar_tpu.audio.pitch")
j_feat = importlib.import_module("ssar_tpu.audio.features")

FPS = 24
SR = 1024 * FPS
CHUNK = 96  # 10 s = 240 frames -> 3 chunks of 80 frames with halos of 64


def _track(frames: int) -> np.ndarray:
    """A 0.2-bin-sharp 220 Hz tone with quiet noise for the first 4 s (the
    tuning estimate's window: its histogram's top bin wins by a wide margin),
    then an arpeggio with louder noise; a click every half second
    throughout."""
    t = np.arange(frames * 1024) / SR
    rng = np.random.RandomState(0)
    tone = 0.4 * np.sin(2 * np.pi * 220.0 * 2 ** (0.2 / 36) * t)
    notes = 220.0 * 2 ** (np.array([0, 4, 7, 12]) / 12)
    arp = 0.4 * np.sin(2 * np.pi * np.cumsum(notes[(t * 4).astype(int) % 4]) / SR)
    first = t < 4.0
    audio = np.where(first, tone, arp) + np.where(first, 0.02, 0.05) * rng.randn(len(t))
    audio[:: SR // 2] += 1.0
    return audio.astype(np.float32)


@pytest.mark.parametrize("T,n_chunks", [(240, 3), (250, 3), (4320, 3), (4321, 4), (1000, 7), (130, 1), (64, 2),
                                        (200, 5), (7, 3)])
def test_chunk_plan_matches_jax(T, n_chunks):
    assert t_sp._chunk_plan(T, n_chunks) == j_sp._chunk_plan(T, n_chunks)


@pytest.fixture(scope="module")
def track():
    return _track(240)


@pytest.mark.parametrize("tuning", [0.0, None])
def test_audio2features_long_within_parity_budgets(track, tuning):
    if tuning is None:  # the host estimate both packages make, equal on this track
        want_tuning = j_pitch.estimate_tuning(j_feat.harmonic(jnp.asarray(track[: 4 * SR])), SR, bins_per_octave=36)
        got_tuning = t_sp.estimate_tuning(t_feat.harmonic(torch.as_tensor(track[: 4 * SR])), SR, bins_per_octave=36)
        assert got_tuning == want_tuning and want_tuning != 0.0
    want = np.asarray(j_sp.audio2features_long(jnp.asarray(track), SR, FPS, chunk_frames=CHUNK, tuning=tuning))
    before = median_cuda.launches
    got = t_sp.audio2features_long(track, SR, FPS, chunk_frames=CHUNK, tuning=tuning, device="cpu").numpy()
    assert median_cuda.launches == before  # the CPU takes the plain version
    assert got.shape == want.shape == (240, t_feat.N_FEATURES)
    for group, (cols, budget) in t_feat.PARITY_BUDGETS.items():
        err = np.abs(got[:, cols] - want[:, cols]).max()
        assert err <= budget, f"{group}: {err:.3g} > {budget}"


def test_long_form_on_a_ragged_track_matches_the_whole_track_stack(track):
    """250 frames in 3 chunks of 84: the last chunk keeps only 82 frames.  The
    port trims by plain slicing and stays within 1 % of the largest feature
    of the whole-track stack (the bound tests/test_parallel.py sets; the JAX
    package's ``dynamic_slice`` clamps the last chunk's start, and its frames
    land 2 frames late)."""
    audio = _track(250)
    full = t_feat.audio2features(audio, SR, FPS, tuning=0.0, device="cpu").numpy()
    got = t_sp.audio2features_long(audio, SR, FPS, chunk_frames=CHUNK, tuning=0.0, device="cpu").numpy()
    assert got.shape == full.shape == (250, t_feat.N_FEATURES)
    assert np.abs(got - full).max() < 0.01 * np.abs(full).max()


@pytest.mark.parametrize("tuning", [0.0, None])
def test_short_track_goes_to_the_whole_track_stack(track, tuning):
    """A track no longer than one chunk with its halos (96 frames in one chunk
    of 96 + 2 * 64) is ``audio2features``'s, the tuning passed on only when
    given."""
    audio = track[: 4 * SR]
    got = t_sp.audio2features_long(audio, SR, FPS, chunk_frames=CHUNK, tuning=tuning, device="cpu")
    want = t_feat.audio2features(audio, SR, FPS, tuning=tuning, device="cpu")
    assert tuple(got.shape) == (96, t_feat.N_FEATURES) and torch.equal(got, want)
