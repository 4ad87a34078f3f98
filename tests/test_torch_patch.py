"""The port's random-patch system against the JAX package's, small, on the CPU.

Random draws: the port draws through ``ssar_tpu_torch.generate.keys``
(``torch.Generator``); here the ``jax_draws`` fixture replaces its functions
by wrappers over ``jax.random``, so both packages see the same draws and the
same patch structure.

Tolerances.  Splines, latent subpatches and noise windows: rtol 1e-5, atol
1e-5 (float32 solves, einsums and gaussian convolutions summed in another
order).  ``Patch.forward`` on JAX's music information: latents and every
layer's noise window within atol 1e-4 (up to 20 subpatches applied one on
another).  ``retrieve_music_information``: each feature within the
docs/PARITY.md budget of its group, the same tempo, the same CQT labels
(the track is one on which both packages choose alike, as in
tests/test_torch_optimize.py), and the same labels from the same numpy
features (labels of a feature's own segmentation can flip on float32
round-off of the feature).  ``sample.generate``: each chunk's float32 frames
within 1e-3 of JAX's synthesis of the same latents and noise windows.
"""
import functools
import importlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.audio.features import PARITY_BUDGETS
from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.generate import interactive as t_inter
from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.generate import latent as t_lat
from ssar_tpu_torch.generate import mir as t_mir
from ssar_tpu_torch.generate import noise as t_noise
from ssar_tpu_torch.generate import patch as t_patch
from ssar_tpu_torch.generate import sample as t_sample

j_lat = importlib.import_module("ssar_tpu.generate.latent")
j_noise = importlib.import_module("ssar_tpu.generate.noise")
j_mir = importlib.import_module("ssar_tpu.generate.mir")
j_patch = importlib.import_module("ssar_tpu.generate.patch")
j_sample = importlib.import_module("ssar_tpu.generate.sample")
j_inter = importlib.import_module("ssar_tpu.generate.interactive")
js = importlib.import_module("ssar_tpu.gan.stylegan2")

KS = (2, 4)
FPS = 12
# the docs/PARITY.md group of each named feature
GROUP = {"chromagram": "chroma", "tonnetz": "tonnetz", "mfcc": "mfcc", "spectral_contrast": "contrast",
         "spectral_flatness": "flatness", "rms": "rms", "drop_strength": "drop_strength", "onsets": "onsets"}


def _track():
    """4 s at 12 fps (T = 48) in two halves, as tests/test_torch_optimize.py
    picks it: a quiet-noise 220 Hz half and a noisy 330 Hz half with a click
    every half second, on which the tuning estimate and the hard CQT labels
    come out the same in both packages whatever the round-off."""
    sr = 1024 * FPS
    t = np.arange(sr * 4) / sr
    rng = np.random.RandomState(0)
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < 2.0, 220.0, 330.0)) / sr)
             + np.where(t < 2.0, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    return audio, sr


def _close(got, want, rtol=1e-5, atol=1e-5):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture
def jax_draws(monkeypatch):
    """``keys`` replaced by wrappers over ``jax.random``: JAX's draws exactly."""
    monkeypatch.setattr(keys, "PRNGKey", jax.random.PRNGKey)
    monkeypatch.setattr(keys, "split", lambda key, num=2: tuple(jax.random.split(key, num)))
    monkeypatch.setattr(keys, "normal", lambda key, shape=(), device=None:
                        torch.as_tensor(np.array(jax.random.normal(key, tuple(shape))), device=device))
    monkeypatch.setattr(keys, "uniform", lambda key: float(jax.random.uniform(key)))
    monkeypatch.setattr(keys, "randint", lambda key, lo, hi: int(jax.random.randint(key, (), lo, hi)))
    monkeypatch.setattr(keys, "permutation", lambda key, n: _t(jax.random.permutation(key, n)))
    monkeypatch.setattr(keys, "choice", lambda key, n, p: int(jax.random.choice(
        key, n, p=jnp.asarray(np.asarray(p, np.float32)))))


@pytest.fixture(scope="module")
def jax_mir():
    """JAX's music information of the 4 s track (T = 48 at 12 fps)."""
    audio, sr = _track()
    return audio, sr, j_mir.retrieve_music_information(jnp.asarray(audio), sr, ks=KS)


def _port_mir(jm):
    """JAX's (features, segmentations, tempo) as the port's tensors."""
    feats, segs, tempo = jm
    return {k: _t(v) for k, v in feats.items()}, {k: _t(v).long() for k, v in segs.items()}, tempo


# ----------------------------------------------------------------- keys --
def test_keys_are_deterministic_and_devices_own_banks():
    k = keys.PRNGKey(42)
    assert k == (0, 42) and keys.PRNGKey(2**40 + 3) == (256, 3)
    a, b = keys.split(k)
    assert a != b and keys.split(k) == (a, b) and len(set(keys.split(k, 3))) == 3
    assert torch.equal(keys.normal(a, (3, 4)), keys.normal(a, (3, 4)))
    assert not torch.equal(keys.normal(a, (3, 4)), keys.normal(b, (3, 4)))
    s = keys.normal(a)
    assert s.shape == () and s.device.type == "cpu"
    assert keys.normal(a, (2, 5), device="cpu").device.type == "cpu"
    assert 0.0 <= keys.uniform(a) < 1.0 and keys.uniform(a) == keys.uniform(a)
    assert all(3 <= keys.randint(kk, 3, 15) < 15 for kk in keys.split(k, 50))
    assert sorted(keys.permutation(a, 10).tolist()) == list(range(10))
    draws = [keys.choice(kk, 3, torch.tensor([0.0, 0.25, 0.75])) for kk in keys.split(k, 400)]
    assert 0 not in draws and 80 < draws.count(1) < 120


# --------------------------------------------------------------- latent --
def test_natural_cubic_spline_and_loop_match_jax(rng):
    t_in = np.sort(rng.rand(7)).astype(np.float32)
    y = rng.randn(7, 3, 5).astype(np.float32)
    t_out = np.linspace(-0.1, 1.1, 40).astype(np.float32)
    want = j_lat.natural_cubic_spline(jnp.asarray(t_in), jnp.asarray(y), jnp.asarray(t_out))
    _close(t_lat.natural_cubic_spline(_t(t_in), _t(y), _t(t_out)), want)
    pal = rng.randn(5, 4, 8).astype(np.float32)
    for n_loops in (1.0, 2.5):
        _close(t_lat.spline_loop_latents(_t(pal), 37, n_loops),
               j_lat.spline_loop_latents(jnp.asarray(pal), 37, n_loops))


def _lat_inputs(rng, T=40):
    palette = rng.randn(24, 18, 16).astype(np.float32)
    latents = rng.randn(T, 18, 16).astype(np.float32)
    feats = {"rms": rng.rand(T, 1).astype(np.float32), "chromagram": rng.rand(T, 12).astype(np.float32)}
    segs = {("rms", 4): rng.randint(0, 4, T), ("chromagram", 4): rng.rand(T, 4).astype(np.float32)}
    return palette, latents, feats, segs


@pytest.mark.parametrize("merge_type", ["average", "modulate", "overwrite"])
@pytest.mark.parametrize("patch_type,seq_feat", [("segmentation", "rms"), ("segmentation", "chromagram"),
                                                 ("feature", "rms"), ("feature", "chromagram"), ("loop", "rms")])
def test_latent_patch_matches_jax(rng, jax_draws, patch_type, seq_feat, merge_type):
    """Every patch type x merge type; the feature type with n_select 1 and
    12; a segmentation given as labels and as soft (T, k) assignments."""
    palette, latents, feats, segs = _lat_inputs(rng)
    kw = dict(patch_type=patch_type, segments=4, loop_bars=4, seq_feat=seq_feat, seq_feat_weight=0.8,
              mod_feat="rms", mod_feat_weight=0.7, merge_type=merge_type, merge_depth="midhigh")
    key = jax.random.PRNGKey(7)
    want = j_lat.latent_patch(key, jnp.asarray(latents), jnp.asarray(palette),
                              {k: jnp.asarray(v) for k, v in segs.items()},
                              {k: jnp.asarray(v) for k, v in feats.items()}, 128.0, 24, **kw)
    got = t_lat.latent_patch(key, _t(latents), _t(palette), {k: _t(v) for k, v in segs.items()},
                             {k: _t(v) for k, v in feats.items()}, 128.0, 24, **kw)
    assert got.shape == latents.shape
    _close(got, want)


# ---------------------------------------------------------------- noise --
def test_noise_windows_match_jax(rng, jax_draws):
    """Each module's (i, b) window, a start past length - b clamped."""
    T, size = 30, (6, 5)
    mod = rng.rand(T, 3).astype(np.float32)
    k = [jax.random.PRNGKey(i) for i in range(3)]
    jm = {"blend": j_noise.Blend(k[0], T, size, jnp.asarray(mod)),
          "multiply": j_noise.Multiply(k[1], T, size, jnp.asarray(mod)),
          "loop": j_noise.Loop(k[2], T, size, n_loops=2.5, sigma=3.0)}
    tm = {"blend": t_noise.Blend(k[0], T, size, _t(mod)), "multiply": t_noise.Multiply(k[1], T, size, _t(mod)),
          "loop": t_noise.Loop(k[2], T, size, n_loops=2.5, sigma=3.0)}
    jm["tree"] = j_noise.ScaleBias(j_noise.Modulate(j_noise.Average(jm["blend"], jm["loop"]), jm["multiply"],
                                                    jnp.asarray(mod)), 0.7, -0.2)
    tm["tree"] = t_noise.ScaleBias(t_noise.Modulate(t_noise.Average(tm["blend"], tm["loop"]), tm["multiply"],
                                                    _t(mod)), 0.7, -0.2)
    for name in jm:
        for i, b in ((0, 8), (11, 8), (27, 8)):   # 27 + 8 > 30: JAX's dynamic_slice clamps the start to 22
            got = tm[name](i, b)
            assert got.shape == (b,) + size
            _close(got, jm[name](i, b))
    _close(tm["loop"].forward(27, 8), tm["loop"](22, 8), 0, 0)


@pytest.mark.parametrize("merge_type", ["average", "modulate", "overwrite"])
@pytest.mark.parametrize("patch_type", ["blend", "multiply", "loop"])
def test_noise_patch_matches_jax(rng, jax_draws, patch_type, merge_type):
    T = 20
    sizes = [(max(s // 32, 1), max(s // 32, 1)) for s in t_patch.NOISE_SIZES]
    feats = {"mfcc": rng.rand(T, 4).astype(np.float32), "rms": rng.rand(T, 1).astype(np.float32)}
    base_j = [j_noise.Loop(jax.random.PRNGKey(i), T, s) for i, s in enumerate(sizes)]
    base_t = [t_noise.Loop(jax.random.PRNGKey(i), T, s) for i, s in enumerate(sizes)]
    kw = dict(patch_type=patch_type, loop_bars=8, seq_feat="mfcc", seq_feat_weight=0.9, mod_feat="rms",
              mod_feat_weight=0.6, merge_type=merge_type, merge_depth="lowmid", noise_mean=0.1, noise_std=0.8)
    key = jax.random.PRNGKey(3)
    want = j_noise.noise_patch(key, base_j, {k: jnp.asarray(v) for k, v in feats.items()}, 120.0, 24, **kw)
    got = t_noise.noise_patch(key, base_t, {k: _t(v) for k, v in feats.items()}, 120.0, 24, **kw)
    assert len(got) == 17
    for g, w in zip(got, want):
        _close(g(5, 6), w(5, 6))


# ---------------------------------------------------------------- patch --
def _fake_mir(rng, T=16):
    feats = {name: rng.rand(T, 2).astype(np.float32) for name in t_mir.ALLFEATS}
    segs = {(name, k): rng.randint(0, k, T) for name in t_mir.ALLFEATS for k in KS}
    return feats, segs


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_patch_structure_and_json_match_jax(rng, jax_draws, tmp_path, seed):
    """The same subpatch dicts as JAX's, and a JSON file either package
    writes loads in the other with the same dicts."""
    feats, segs = _fake_mir(rng)
    jp = j_patch.Patch({k: jnp.asarray(v) for k, v in feats.items()}, segs, 120.0, fps=FPS, seed=seed)
    tp = t_patch.Patch({k: _t(v) for k, v in feats.items()}, segs, 120.0, fps=FPS, seed=seed)
    attrs = ("num_base_latents", "sigma_base_noise", "loops_base_noise", "latent_patches", "noise_patches", "ks")
    for a in attrs:
        assert getattr(tp, a) == getattr(jp, a), a
    assert repr(tp) == repr(jp)
    jp.save(tmp_path / "j.json")
    tp.save(tmp_path / "t.json")
    assert json.loads((tmp_path / "j.json").read_text()) == json.loads((tmp_path / "t.json").read_text())
    other = rng.randint(1000)
    t_loaded = t_patch.Patch.load(tmp_path / "j.json", {k: _t(v) for k, v in feats.items()}, segs, 120.0, FPS,
                                  seed=other)
    j_loaded = j_patch.Patch.load(tmp_path / "t.json", {k: jnp.asarray(v) for k, v in feats.items()}, segs,
                                  120.0, FPS, seed=other)
    for a in attrs[:-1] + ("seed",):
        assert getattr(t_loaded, a) == getattr(jp, a) == getattr(j_loaded, a), a
    # update_intensity re-draws the weights alike
    jp.update_intensity(1.2)
    tp.update_intensity(1.2)
    assert tp.latent_patches == jp.latent_patches and tp.noise_patches == jp.noise_patches


def test_patch_draws_the_same_structure_on_every_call(rng):
    """The port's own draws: one seed, one structure (JSON), whatever the run."""
    feats, segs = _fake_mir(rng)
    a = t_patch.Patch({k: _t(v) for k, v in feats.items()}, segs, 120.0, seed=5)
    b = t_patch.Patch({k: _t(v) for k, v in feats.items()}, segs, 120.0, seed=5)
    c = t_patch.Patch({k: _t(v) for k, v in feats.items()}, segs, 120.0, seed=6)
    assert repr(a) == repr(b) and repr(a) != repr(c)
    assert 5 <= len(a.latent_patches) < 20 and 3 <= a.num_base_latents < 15


# seeds whose latent subpatches never ask for more palette rows than 12 (a
# "feature" subpatch on mfcc takes 20; JAX's einsum refuses those too), with
# every patch and merge type among their 5 noise and 6 / 12 latent subpatches
FORWARD_SEEDS = [6, 53]


@pytest.mark.parametrize("seed", FORWARD_SEEDS)
def test_patch_forward_matches_jax_on_jax_mir(rng, jax_draws, jax_mir, seed):
    """T = 48, a (12, 18, 512) palette: the latents and every layer's noise
    window (a clamped start among them) within 1e-4."""
    _, _, jm = jax_mir
    feats, segs, tempo = _port_mir(jm)
    palette = rng.randn(12, 18, 512).astype(np.float32)
    jp = j_patch.Patch(jm[0], jm[1], jm[2], fps=FPS, seed=seed)
    tp = t_patch.Patch(feats, segs, tempo, fps=FPS, seed=seed)
    assert tp.latent_patches == jp.latent_patches and tp.noise_patches == jp.noise_patches
    lat_j, noise_j = jp.forward(jnp.asarray(palette), downscale_factor=32)
    lat_t, noise_t = tp.forward(_t(palette), downscale_factor=32)
    assert lat_t.shape == (48, 18, 512) and len(noise_t) == 17
    _close(lat_t, lat_j, 0, 1e-4)
    for g, w in zip(noise_t, noise_j):
        for i in (0, 45):
            _close(g(i, 8), w(i, 8), 0, 1e-4)
    # re-seeded every call
    _close(tp.forward(_t(palette), downscale_factor=32)[0], lat_t, 0, 0)


# ------------------------------------------------------------------ mir --
def test_retrieve_music_information_matches_jax(jax_mir):
    audio, sr, (fj, sj, tj) = jax_mir
    ft, st, tt = t_mir.retrieve_music_information(audio, sr, ks=KS, device="cpu")
    assert tt == tj
    assert set(ft) == set(fj) and set(st) == set(sj)
    for name, f in fj.items():
        assert tuple(ft[name].shape) == f.shape == (48, f.shape[1])
        _close(ft[name], f, 0, PARITY_BUDGETS[GROUP[name]][1])
    for k in KS:
        np.testing.assert_array_equal(st[("rosa", k)].numpy(), np.asarray(sj[("rosa", k)]))


def test_mir_segments_jax_features_alike(monkeypatch, jax_mir):
    """JAX's raw features through the port's host segmentation, tempo and
    post-processing: the same labels and tempo, the features within 1e-5."""
    audio, sr, (fj, sj, tj) = jax_mir
    j_ft = importlib.import_module("ssar_tpu.audio.features")
    raw = {fn.__name__: np.asarray(fn(jnp.asarray(audio), sr)) for fn in j_mir.AFEATFNS}

    def raw_fn(name):
        fn = lambda a, s: torch.as_tensor(raw[name])  # noqa: E731
        fn.__name__ = name
        return fn

    onsets = np.asarray(j_ft.onsets(jnp.asarray(audio), sr))
    monkeypatch.setattr(t_mir, "AFEATFNS", [raw_fn(fn.__name__) for fn in j_mir.AFEATFNS])
    monkeypatch.setattr(t_mir, "FT", types.SimpleNamespace(onsets=lambda a, s: torch.as_tensor(onsets)))
    ft, st, tt = t_mir.retrieve_music_information(audio, sr, ks=KS, device="cpu")
    assert tt == tj
    for key, labels in sj.items():
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(labels), err_msg=str(key))
    for name, f in fj.items():
        _close(ft[name], f)


def test_mir_counts_eight_median_filters(monkeypatch):
    """Four harmonic / percussive separations, two median filters each."""
    from ssar_tpu_torch.audio import spectral

    calls = []
    real = spectral.median_filter
    monkeypatch.setattr(spectral, "median_filter", lambda x, k, axis=-1: calls.append(k) or real(x, k, axis))
    audio, sr = _track()
    seconds = {}
    t_mir.retrieve_music_information(audio[: sr * 2], sr, ks=KS, include_rosa=False, device="cpu", seconds=seconds)
    assert calls == [31] * 8
    assert set(seconds) == {"features", "segmentation"}


def test_mir_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mir.retrieve_music_information(np.zeros(12288, np.float32), 12288)


# --------------------------------------------------------------- sample --
def test_load_audio_matches_jax(tmp_path):
    from scipy.io import wavfile

    sr_in = 22050
    t = np.arange(int(1.5 * sr_in)) / sr_in
    wav = (0.5 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, sr_in, wav)
    want, sr_j = j_sample.load_audio(path, 0.25, 1.0, 12)
    got, sr_t = t_sample.load_audio(path, 0.25, 1.0, 12)
    assert sr_t == sr_j == 12288 and got.shape == want.shape
    _close(got, want, 0, 1e-5)


class _Sink:
    def __init__(self):
        self.frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write_i420(self, frame):
        self.frames.append(np.array(frame))

    def write(self, frame):
        self.frames.append(np.array(frame))


def test_generate_on_the_cpu_matches_jax_synthesis(monkeypatch, tmp_path):
    """2 s at 8 fps (16 frames) in batches of 6 at 32 px, float32: 16 frames
    written, the last batch padded by repeating its last frame, the patch
    JSON beside the output, and each batch's frames against JAX's synthesis
    of the same latents and noise windows with the port's weights converted."""
    from ssar_tpu_torch.gan import wrapper as t_wrap

    fps, sr = 8, 8192
    t = np.arange(2 * sr) / sr
    audio = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.RandomState(0).randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    calls, real = [], t_wrap.StyleGAN2Synthesizer.__call__

    def recording(self, latents, noises=None, **kw):
        out = real(self, latents, noises=noises, **kw)
        calls.append((self, latents.clone(), [n.clone() for n in noises], out.clone()))
        return out

    monkeypatch.setattr(t_wrap.StyleGAN2Synthesizer, "__call__", recording)
    monkeypatch.setattr(t_sample, "StyleGAN2", functools.partial(t_wrap.StyleGAN2, dtype=torch.float32))
    sink, stats = _Sink(), {}
    cfg = ts.StyleGAN2Config(resolution=32, max_channels=32)
    out = t_sample.generate(seed=3, fps=fps, downscale_factor=1, batch_size=6, config=cfg, audio=audio, sr=sr,
                            out_dir=str(tmp_path), writer=sink, device="cpu", stats=stats)
    assert len(sink.frames) == stats["frames"] == 16 and sink.frames[0].shape == (48, 32)
    assert json.loads((tmp_path / "synthetic_RandomPatches_seed3_32x32.json").read_text())["seed"] == 3
    assert out.endswith("synthetic_RandomPatches_seed3_32x32.mp4")
    assert len(calls) == 3 and stats["bank_bytes"] > 0
    syn = calls[0][0]
    params = ts.params_to_jax(syn.params)
    frames = []
    for _, lat, noises, img in calls:
        want = js.synthesis(params, jnp.asarray(lat.numpy()), [jnp.asarray(n.numpy()) for n in noises],
                            js.StyleGAN2Config(resolution=32, max_channels=32), dtype=jnp.float32)
        _close(img, want, 0, 1e-3)
        frames.append(img)
    # the third batch holds frames 12-15: its rows 4 and 5 repeat its row 3, frame 15
    _close(calls[2][1][4:], calls[2][1][3:4].expand(2, -1, -1), 0, 0)
    for n in calls[2][2]:
        _close(n[4:], n[3:4].expand(2, -1, -1, -1), 0, 0)


def test_generate_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sample.generate(seed=0, audio=np.zeros(12288, np.float32), sr=12288, fps=12)


def test_sample_smoke_cli_runs_on_the_cpu(tmp_path):
    out = t_sample.main(["--smoke", "--device", "cpu", "--out_dir", str(tmp_path)])
    assert out.endswith("_64x64.mp4") and (tmp_path / "synthetic_RandomPatches_seed42_64x64.json").exists()


# ---------------------------------------------------------- interactive --
def test_manual_segmentation_matches_jax():
    for k in (2, 4):
        np.testing.assert_array_equal(t_inter.manual_segmentation([5, 20, 12], 30, k).numpy(),
                                      np.asarray(j_inter.manual_segmentation([5, 20, 12], 30, k)))


def test_interactive_session_commands_match_jax(monkeypatch, jax_draws, jax_mir):
    """Seed, intensity, reroll, permute, segments and revert edit the patch
    as JAX's session does (both on JAX's music information)."""
    audio, sr, jm = jax_mir
    monkeypatch.setattr(t_inter, "retrieve_music_information", lambda a, s, device=None: _port_mir(jm))
    monkeypatch.setattr(j_inter, "retrieve_music_information", lambda a, s: (dict(jm[0]), dict(jm[1]), jm[2]))
    js_, ts_ = j_inter.InteractiveSession(audio, sr, fps=FPS, seed=4), t_inter.InteractiveSession(audio, sr, fps=FPS,
                                                                                                 seed=4)

    def same():
        assert ts_.patch.latent_patches == js_.patch.latent_patches
        assert ts_.patch.noise_patches == js_.patch.noise_patches

    same()
    for s in (js_, ts_):
        s.cmd_seed(9)
        s.cmd_intensity(0.9)
        s.cmd_reroll(1)
        s.cmd_reroll(0, noise=True)
        s.cmd_permute()
        s.cmd_permute(noise=True)
    same()
    for s in (js_, ts_):
        s.cmd_revert()
    same()
    for s in (js_, ts_):
        s.cmd_segments([10, 30])
    for key, labels in js_.segmentations.items():
        np.testing.assert_array_equal(ts_.segmentations[key].numpy(), np.asarray(labels))
    ts_.cmd_palette()   # no generator attached: prints and changes nothing
    assert ts_.palette is None and ts_.cmd_render() is None
