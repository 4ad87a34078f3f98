"""The port's video features (``video/features.py``), optical flow
(``video/flow.py``) and visual beats (``video/visual_beats.py``) against the
JAX package's, small, on the CPU.

Both packages take the same numpy clips made from a seed: a textured clip
(six drifting gratings a channel, a subpixel shift a frame) so that the
flow is well posed everywhere.  Tolerances:
- ``_histc``, the seven histogram features, ``rgb_hist`` and ``hsv_hist``:
  equal (the same float32 bin arithmetic);
- ``rgb_to_hsv``: 1e-6;
- the spatial spectrum and the four band RMS features: rtol 1e-4;
  ``visual_variance`` and ``absdiff``: rtol 1e-5;
- ``poly_expansion``: 1e-4 of the largest coefficient;
  ``farneback_flow``, ``farneback_parametrized`` and
  ``lucas_kanade_pyramid``: 1e-3 px on the interior (8 px from each edge).
  ``farneback_parametrized`` is held at one or two iterations: its gather
  truncates the flow to whole pixels, so from the third iteration a flow
  within round-off (1e-4) of an integer lands on another pixel in one
  package, and the gaussian window spreads that pixel's change (3.5e-2 px
  at 3 iterations, 2.4e-2 with a two-level pyramid, whose upsampled flow
  is truncated at once; ROADMAP C);
- the optical-flow features, ``directogram`` and the two onset features:
  1e-4 of their largest magnitude, and the same tempo and beats from the
  onset envelopes; ``visual_beats``: the same tempo and beats, its motion
  envelope within 1e-3 (``directogram``'s floor(flow * 255) moves a pixel
  by one level where a magnitude lies within round-off of a level's edge).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.audio.beat_host import beat_track
from ssar_tpu_torch.video import features as t_vf
from ssar_tpu_torch.video import flow as t_flow
from ssar_tpu_torch.video import visual_beats as t_vb

j_vf = importlib.import_module("ssar_tpu.video.features")
j_flow = importlib.import_module("ssar_tpu.video.flow")
j_vb = importlib.import_module("ssar_tpu.video.visual_beats")

EXACT = {"rgb_hist", "hsv_hist"}
SPECTRAL = {"video_spectrogram", "low_freq_rms", "mid_freq_rms", "high_freq_rms", "adaptive_freq_rms"}
MOTION = {"video_flow_onsets", "video_spectral_onsets", "directogram"}
EDGE = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _clip(T=24, H=48, W=64, seed=0, speed=(0.7, -0.4)):
    """(T, 3, H, W) in [0, 1]: six gratings a channel drifting by `speed`
    pixels a frame."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = np.zeros((T, 3, H, W))
    t = np.arange(T)[:, None, None]
    for c in range(3):
        for _ in range(6):
            fx, fy = rng.uniform(0.05, 0.25, 2) * rng.choice([-1, 1], 2)
            ph = rng.uniform(0, 2 * np.pi)
            out[:, c] += np.sin(2 * np.pi * (fx * (xx - speed[0] * t) + fy * (yy - speed[1] * t)) + ph)
    return ((out - out.min()) / (out.max() - out.min())).astype(np.float32)


CLIP = _clip()


def _constant_frame_clip():
    """A clip with a constant frame (every histogram's range is 0 there)."""
    v = _clip(T=12, H=32, W=32, seed=2)
    v[4] = 0.5
    return v


# ------------------------------------------------------------ histograms --
def test_histc_matches_jax():
    rng = np.random.RandomState(1)
    rows = rng.rand(6, 500).astype(np.float32)
    rows[1] = 0.25                      # a constant row
    rows[2, :7] = rows[2].max()          # values on the upper edge
    rows[3] = np.round(rows[3] * 8) / 8  # values on the bin edges
    for bins in (8, 32, 33):
        want = np.stack([np.asarray(j_vf._histc(jnp.asarray(r), bins)) for r in rows])
        np.testing.assert_array_equal(t_vf._histc_rows(_t(rows), bins).numpy(), want)
        np.testing.assert_array_equal(t_vf._histc(_t(rows[0]), bins).numpy(), want[0])


@pytest.mark.parametrize("name", ["redogram", "greenogram", "blueogram", "huestogram", "saturogram",
                                  "valueogram", "rgb_hist", "hsv_hist"])
def test_histogram_features_equal_jax(name):
    for video in (CLIP, _constant_frame_clip()):
        want = np.asarray(getattr(j_vf, name)(jnp.asarray(video)))
        np.testing.assert_array_equal(getattr(t_vf, name)(_t(video)).numpy(), want)


def test_rgb_to_hsv_matches_jax():
    rng = np.random.RandomState(3)
    v = rng.rand(4, 3, 16, 16).astype(np.float32)
    v[0, :, :4] = 0.3            # grey: delta 0
    v[1, :, :4] = 0.0            # black: max 0
    v[2, 0, :4] = v[2, 1, :4]    # r == g ties
    np.testing.assert_allclose(t_vf.rgb_to_hsv(_t(v)).numpy(), np.asarray(j_vf.rgb_to_hsv(jnp.asarray(v))),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------- all the features --
@pytest.fixture(scope="module")
def jax_features():
    clips = {"textured": CLIP, "constant_frame": _constant_frame_clip()}
    return {k: (v, {n: np.asarray(fn(jnp.asarray(v))) for n, fn in j_vf.VIDEO_FEATURES.items()})
            for k, v in clips.items()}


@pytest.mark.parametrize("clip", ["textured", "constant_frame"])
@pytest.mark.parametrize("name", sorted(j_vf.VIDEO_FEATURES))
def test_video_features_match_jax(jax_features, clip, name):
    video, want_all = jax_features[clip]
    want = want_all[name]
    got = t_vf.VIDEO_FEATURES[name](_t(video)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    elif name in SPECTRAL:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    elif name in MOTION:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
        if name != "directogram":
            (bpm, beats), (want_bpm, want_beats) = (beat_track(e[:, 0], sr=24 * 1024) for e in (got, want))
            assert bpm == want_bpm and np.array_equal(beats, want_beats)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_optical_flow_matches_jax():
    want = np.asarray(j_vf.optical_flow(jnp.asarray(CLIP)))
    got = t_vf.optical_flow(_t(CLIP)).numpy()
    assert got.shape == (24, 2, 48, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_optical_flow_in_chunks_equals_one_call(monkeypatch):
    """Farneback over frame pairs in chunks computes the same flow."""
    whole = t_vf.optical_flow(_t(CLIP[:10]))
    monkeypatch.setattr(t_vf, "FLOW_CHUNK_PIXELS", 3 * 48 * 64)
    np.testing.assert_allclose(t_vf.optical_flow(_t(CLIP[:10])).numpy(), whole.numpy(), rtol=0, atol=1e-6)


def test_optical_flow_cv2_backend_matches_jax():
    video = _clip(T=6, H=32, W=32, seed=4)
    want = np.asarray(j_vf.optical_flow(jnp.asarray(video), backend="cv2"))
    np.testing.assert_allclose(t_vf.optical_flow(_t(video), backend="cv2").numpy(), want, rtol=0, atol=1e-6)


# ----------------------------------------------------------------- flow --
def _interior(a):
    return a[..., EDGE:-EDGE, EDGE:-EDGE]


def test_poly_expansion_matches_jax():
    g = CLIP[:3].mean(1) * 255
    for n, sigma in ((7, 1.5), (3, 1.0)):
        want = j_flow.poly_expansion(jnp.asarray(g), n, sigma)
        got = t_flow.poly_expansion(_t(g), n, sigma)
        for a, b in zip(got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("kw", [{}, {"levels": 1, "iterations": 5}, {"levels": 2, "poly_n": 5, "win": 9}])
def test_farneback_flow_matches_jax(kw):
    g = CLIP[:6].mean(1)
    want = np.asarray(j_flow.farneback_flow(jnp.asarray(g), **kw))
    got = t_flow.farneback_flow(_t(g), **kw).numpy()
    assert got.shape == (5, 2, 48, 64)
    np.testing.assert_allclose(_interior(got), _interior(want), rtol=0, atol=1e-3)
    assert abs(np.median(_interior(got)[:, 0]) - 0.7) < 0.2  # the clip's drift


@pytest.mark.parametrize("kw", [{"model": "constant"}, {"model": "affine"}, {"model": "eight_param"},
                                {"model": "constant", "num_iter": 2}, {"model": "constant", "mu": -1.0, "num_iter": 2},
                                {"model": "affine", "mu": -1.0}, {"model": "constant", "mu": 2.0}])
def test_farneback_parametrized_matches_jax(kw):
    g = CLIP[:4].mean(1)
    want = np.asarray(j_flow.farneback_parametrized(jnp.asarray(g), **kw))
    got = t_flow.farneback_parametrized(_t(g), **kw).numpy()
    np.testing.assert_allclose(_interior(got), _interior(want), rtol=0, atol=1e-3)


def test_poly_expansion_certainty_matches_jax():
    g = CLIP[:2].mean(1) * 255
    cert = j_flow._border_certainty(48, 64)
    want = j_flow.poly_expansion_certainty(jnp.asarray(g), jnp.asarray(np.broadcast_to(cert, g.shape)), 2.0)
    got = t_flow.poly_expansion_certainty(_t(g), _t(cert), 2.0)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy()[:, EDGE:-EDGE, EDGE:-EDGE], b[:, EDGE:-EDGE, EDGE:-EDGE],
                                   rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("levels", [2, 4])
def test_lucas_kanade_pyramid_matches_jax(levels):
    g = CLIP[:2].mean(1)
    want = np.asarray(j_flow.lucas_kanade_pyramid(jnp.asarray(g[0]), jnp.asarray(g[1]), levels=levels))
    got = t_flow.lucas_kanade_pyramid(_t(g[0]), _t(g[1]), levels=levels).numpy()
    assert got.shape == want.shape == (24, 32, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ------------------------------------------------------------- beats --
def test_visual_beats_match_jax():
    """A clip that jumps every 10 frames: the same tempo and beat frames."""
    rng = np.random.RandomState(5)
    v = _clip(T=96, H=32, W=32, seed=6, speed=(0.3, 0.2))
    for t in range(0, 96, 10):
        v[t:] = np.roll(v[t:], 3, axis=-1)
    v += 0.01 * rng.rand(*v.shape).astype(np.float32)
    want_bpm, want_beats = j_vb.visual_beats(jnp.asarray(v), fps=24.0)
    bpm, beats = t_vb.visual_beats(_t(v), fps=24.0)
    assert bpm == want_bpm and np.array_equal(beats, want_beats)
    # floor(flow * 255) moves by one level where a magnitude lies within round-off of a level's edge: the
    # envelopes agree within 1e-3 (1.3e-4 here), which leaves the beats unchanged
    np.testing.assert_allclose(t_vb.video_onsets(_t(v)).numpy(), np.asarray(j_vb.video_onsets(jnp.asarray(v))),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_vb.video_spectral_beat_envelope(_t(v)).numpy(),
                               np.asarray(j_vb.video_spectral_beat_envelope(jnp.asarray(v))), rtol=0, atol=1e-4)
