"""The port's patch-authoring API (``generate/audioreactive.py``), its
``RandomPatch`` and ``render_patch``, and the six ported example patches,
against the JAX package's, small, on the CPU.

Both packages take the same numpy audio, palettes and weights; the port's
draws are JAX's (``keys`` replaced by wrappers over ``jax.random``).
Tolerances: signal ops, loops and primitives within 1e-5; feature
envelopes within 1e-4 (one within 5e-4, see ``ENVELOPES``); the same
segmentation labels, tempo and ``RandomPatch`` choices; the examples'
latents and noises, which mix several envelopes, within 1e-3 (the
docs/PARITY.md budget of the chroma and tonnetz groups); synthesised frames
within 1e-3 (float32 convolutions summed in another order).
"""
import importlib
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.gan import wrapper as t_wrap
from ssar_tpu_torch.generate import audioreactive as t_ar
from ssar_tpu_torch.generate import keys

j_ar = importlib.import_module("ssar_tpu.generate.audioreactive")
js = importlib.import_module("ssar_tpu.gan.stylegan2")
j_wrap = importlib.import_module("ssar_tpu.gan.wrapper")

ROOT = Path(__file__).resolve().parents[1]
FPS = 12
SR = 1024 * FPS
EXAMPLES = ["base_patch", "tempo_loop_noise_patch", "widescreen_bend_patch", "perlin_tonal_noise_patch",
            "segmentation_noise_sections_patch", "tracklist_truncation_patch"]


def _track():
    """4 s at 12 fps (T = 48), the track of tests/test_torch_optimize.py on
    which both packages' tuning estimates and CQT labels agree."""
    t = np.arange(SR * 4) / SR
    rng = np.random.RandomState(0)
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < 2.0, 220.0, 330.0)) / SR)
             + np.where(t < 2.0, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: SR // 2] += 1.0
    return audio


AUDIO = _track()
T = len(AUDIO) // 1024


def _close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture
def jax_draws(monkeypatch):
    """``keys`` replaced by wrappers over ``jax.random``: JAX's draws exactly."""
    monkeypatch.setattr(keys, "PRNGKey", jax.random.PRNGKey)
    monkeypatch.setattr(keys, "split", lambda key, num=2: tuple(jax.random.split(key, num)))
    monkeypatch.setattr(keys, "normal", lambda key, shape=(), device=None:
                        torch.as_tensor(np.array(jax.random.normal(key, tuple(shape))), device=device))


# ---------------------------------------------------------- signal ops --
def test_signal_ops_and_loaders_match_jax(rng, tmp_path):
    x = rng.rand(40, 3).astype(np.float32)
    for fn, args in ((j_ar.compress, (0.4, 0.5)), (j_ar.expand, (0.3, 3.0))):
        _close(getattr(t_ar, fn.__name__)(_t(x), *args), fn(jnp.asarray(x), *args))
    _close(t_ar._to_frames(_t(x), 57), j_ar._to_frames(jnp.asarray(x), 57))
    _close(t_ar._to_frames(_t(x[:, 0]), 23), j_ar._to_frames(jnp.asarray(x[:, 0]), 23))
    _close(t_ar.wrapping_slice(_t(x), 35, 12), j_ar.wrapping_slice(jnp.asarray(x), 35, 12))
    _close(t_ar.percentile_clip(_t(x), 80), j_ar.percentile_clip(jnp.asarray(x), 80))
    _close(t_ar.gaussian_filter(_t(x), 3, causal=0.5), j_ar.gaussian_filter(jnp.asarray(x), 3, causal=0.5))
    np.save(tmp_path / "lat.npy", x)
    np.savez(tmp_path / "lat.npz", first=x, second=2 * x)
    for name in ("lat.npy", "lat.npz"):
        _close(t_ar.load_latents(str(tmp_path / name)), j_ar.load_latents(str(tmp_path / name)), 0, 0)


def test_load_audio_returns_audio_rate_and_duration(tmp_path):
    from scipy.io import wavfile

    wavfile.write(tmp_path / "a.wav", SR, (AUDIO * 16000).astype(np.int16))
    got = t_ar.load_audio(str(tmp_path / "a.wav"), 0.5, 2.0, device="cpu")
    want = j_ar.load_audio(str(tmp_path / "a.wav"), 0.5, 2.0)
    assert got[1:] == want[1:] == (SR, 2.0)
    _close(got[0], want[0], 0, 0)


# --------------------------------------------------- feature envelopes --
# (name, knobs, atol): the envelopes are min-max normalised, which magnifies
# float32 round-off by 1 / (range before normalising); rms smoothed by
# sigma 20 on 4 s spans 0.0016 around 0.30, so 1.2e-7 of round-off in the
# smoothing becomes ~1e-4 (5e-4 allowed there, 1e-4 elsewhere)
ENVELOPES = [
    ("onsets", dict(fmin=200, clip=94, smooth=2, power=1), 1e-4),
    ("onsets", dict(fmin=30, fmax=200, clip=95, smooth=1.5), 1e-4),
    ("onsets", dict(smooth=0, power=2.0), 1e-4),
    ("volume", dict(smooth=3), 1e-4),
    ("rms", dict(smooth=20), 5e-4),
    ("rms", dict(fmin=100, fmax=400, clip=90, power=2), 1e-4),
    ("rms", dict(fmax=100), 1e-4),
    ("rms", dict(fmin=5000), 1e-4),
    ("chroma", dict(), 1e-4),
    ("chroma", dict(nearest_neighbor=True), 0),
    ("tonnetz", dict(), 1e-4),
    ("pitch_track", dict(), 1e-4),
]


@pytest.mark.parametrize("name,kw,atol", ENVELOPES)
def test_envelopes_match_jax(name, kw, atol):
    """At T and at another frame count (resampled linearly)."""
    for n in (T, 60):
        want = getattr(j_ar, name)(jnp.asarray(AUDIO), SR, n, **kw)
        got = getattr(t_ar, name)(_t(AUDIO), SR, n, **kw)
        assert tuple(got.shape) == want.shape
        _close(got, want, atol, 1e-4)


def test_tempo_and_segmentation_match_jax():
    for prior in ("lognormal", "uniform"):
        assert t_ar.tempo(_t(AUDIO), SR, prior) == j_ar.tempo(jnp.asarray(AUDIO), SR, prior)
    want = j_ar.laplacian_segmentation(jnp.asarray(AUDIO), SR, T, ks=(2, 4))
    got = t_ar.laplacian_segmentation(_t(AUDIO), SR, T, ks=(2, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- loops, primitives --
@pytest.mark.parametrize("n_loops", [1.0, 2.7])
def test_loops_match_jax(rng, n_loops):
    sel = rng.randn(5, 4, 16).astype(np.float32)
    for name, kw in (("slerp_loops", dict(smoothing=2.0)), ("slerp_loops", dict(loop=False, smoothing=0)),
                     ("spline_loops", dict(smoothing=3.0)), ("gaussian_loops", {}), ("constant_loops", {})):
        _close(getattr(t_ar, name)(_t(sel), 37, n_loops, **kw), getattr(j_ar, name)(jnp.asarray(sel), 37, n_loops,
                                                                                    **kw))
    for loop in t_ar.LOOP_TYPES:
        _close(t_ar.TempoLoopLatents(128.0, _t(sel), 37, fps=FPS, n_bars=1, type=loop, smooth=2),
               j_ar.TempoLoopLatents(128.0, jnp.asarray(sel), 37, fps=FPS, n_bars=1, type=loop, smooth=2))


def test_primitives_match_jax(rng, jax_draws):
    env = rng.rand(T).astype(np.float32)
    base = rng.randn(T, 4, 16).astype(np.float32)
    pal = rng.randn(12, 4, 16).astype(np.float32)
    chroma = rng.rand(T, 12).astype(np.float32)
    _close(t_ar.ModulatedLatents(_t(env), _t(base), _t(pal[0])), j_ar.ModulatedLatents(env, base, pal[0]))
    _close(t_ar.ModulatedLatents(_t(env), _t(base), _t(base[::-1])), j_ar.ModulatedLatents(env, base, base[::-1]))
    _close(t_ar.ModulatedNoise(_t(env), _t(base[:, 0]), _t(base[:, 1])),
           j_ar.ModulatedNoise(env, base[:, 0], base[:, 1]))
    pc = (12 * rng.rand(T)).astype(np.float32)
    _close(t_ar.PitchTrackLatents(_t(pc), _t(pal)), j_ar.PitchTrackLatents(jnp.asarray(pc), jnp.asarray(pal)))
    _close(t_ar.TonalLatents(_t(chroma), _t(pal)), j_ar.TonalLatents(jnp.asarray(chroma), jnp.asarray(pal)))
    _close(t_ar.chroma_weight_latents(chroma, pal), j_ar.chroma_weight_latents(chroma, pal))
    key = jax.random.PRNGKey(4)
    _close(t_ar.TonalNoise(key, _t(chroma), (6, 5)), j_ar.TonalNoise(key, jnp.asarray(chroma), (6, 5)))
    _close(t_ar.TempoLoopNoise(key, 110.0, (6, 5), T, fps=FPS), j_ar.TempoLoopNoise(key, 110.0, (6, 5), T, fps=FPS))
    for k in (3, key):   # an int seed or a key; two octaves: the cubic resize up on every axis
        _close(t_ar.perlin_noise(k, (T, 16, 12), (4, 2, 2), octaves=2),
               j_ar.perlin_noise(k, (T, 16, 12), (4, 2, 2), octaves=2))
    for kw in (dict(), dict(center=(5, 3), radius=3.5, soft=1.5)):
        _close(t_ar.circular_mask(9, 12, **kw), j_ar.circular_mask(9, 12, **kw))


def test_bends_follow_jax_in_nchw(rng):
    """The port's bends see NCHW activations: ``AddNoise`` takes the NCHW
    (1, 1, H, W) field and the NHWC (1, H, W, 1) one alike, and
    ``replication_pad`` pads the last two axes."""
    x = rng.randn(2, 3, 4, 4).astype(np.float32)
    field = rng.randn(1, 5, 8, 1).astype(np.float32)   # NHWC, as the JAX package's patches write it
    want = j_ar.sequential(j_ar.replication_pad(2, 2, 1, 0), j_ar.AddNoise(field))(jnp.asarray(x.transpose(0, 2, 3, 1)))
    for f in (field.transpose(0, 3, 1, 2), field):
        got = t_ar.sequential(t_ar.replication_pad(2, 2, 1, 0), t_ar.AddNoise(f))(_t(x))
        assert tuple(got.shape) == (2, 3, 5, 8)
        _close(got.permute(0, 2, 3, 1), want, 0, 0)


def test_plots_write_their_files(tmp_path, rng):
    sig = [_t(rng.rand(30)), rng.rand(30, 2)]
    assert Path(t_ar.plot_signals(sig, str(tmp_path / "s.pdf"))).stat().st_size > 0
    assert Path(t_ar.plot_spectra([_t(rng.rand(30, 12))], str(tmp_path / "p.pdf"))).stat().st_size > 0


# ----------------------------------------------------------- RandomPatch --
@pytest.mark.parametrize("seed", range(8))
def test_random_patch_matches_jax(rng, jax_draws, seed):
    """Seeds 0-7: the same choices, the same kind of target, the same values."""
    jp, tp = j_ar.RandomPatch(seed, fps=FPS), t_ar.RandomPatch(seed, fps=FPS)
    assert repr(tp) == repr(jp)
    pal = rng.randn(12, 18, 16).astype(np.float32)
    base = rng.randn(T, 18, 16).astype(np.float32)
    kind_j, want = jp.forward(jnp.asarray(AUDIO), SR, jnp.asarray(pal), jnp.asarray(base), noise_size=(6, 4))
    kind_t, got = tp.forward(_t(AUDIO), SR, _t(pal), _t(base), noise_size=(6, 4))
    assert kind_t == kind_j and tuple(got.shape) == want.shape
    _close(got, want, 1e-4, 1e-4)


# ------------------------------------------------ render_patch, examples --
CFG = dict(resolution=32, max_channels=16)


@pytest.fixture(scope="module")
def synths():
    """A JAX synthesizer at 32 px in float32 and the port's on its weights."""
    jsyn = j_wrap.StyleGAN2Synthesizer(config=js.StyleGAN2Config(**CFG), dtype=jnp.float32, seed=1)
    params = jax.tree_util.tree_map(np.asarray, jsyn.params)
    tsyn = t_wrap.StyleGAN2Synthesizer(config=ts.StyleGAN2Config(**CFG), dtype=torch.float32, device="cpu",
                                       params=ts.params_from_jax(params))
    return jsyn, tsyn


def _noise_at(n, T_):
    """A noise slot as a (T, H, W) array: lazy modules evaluated over the
    whole track."""
    if n is None:
        return None
    if callable(n) and not isinstance(n, (np.ndarray, jax.Array, torch.Tensor)):
        n = n(0, T_)
    n = np.asarray(n.detach().numpy() if isinstance(n, torch.Tensor) else n)
    return n[:, 0] if n.ndim == 4 else n


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_patches_match_jax(jax_draws, synths, rng, name):
    """Each ported example against its JAX original: latents, every noise
    slot (None where JAX's is None) and, where it bends, frames."""
    jsyn, tsyn = synths
    j_mod = j_ar.load_patch_module(str(ROOT / "examples" / f"{name}.py"))
    t_mod = t_ar.load_patch_module(str(ROOT / "ssar_tpu_torch" / "examples" / f"{name}.py"))
    pal = rng.randn(12, jsyn.config.n_latent, 512).astype(np.float32)
    lat_j, noise_j = j_ar.render_patch(j_mod, jnp.asarray(AUDIO), SR, fps=FPS, palette=jnp.asarray(pal),
                                       synthesizer=jsyn)
    lat_t, noise_t = t_ar.render_patch(t_mod, AUDIO, SR, fps=FPS, palette=pal, synthesizer=tsyn)
    assert tuple(lat_t.shape) == lat_j.shape == (T, jsyn.config.n_latent, 512)
    _close(lat_t, lat_j, 1e-3, 1e-3)
    if noise_j is None:
        assert noise_t is None
    else:
        assert len(noise_t) == len(noise_j) == tsyn.n_noises_used
        for a, b in zip(noise_t, noise_j):
            a, b = _noise_at(a, T), _noise_at(b, T)
            assert (a is None) == (b is None)
            if b is not None:
                _close(a, b, 1e-3, 1e-3)
    if tsyn.bends:
        want = jsyn(lat_j[:2])
        got = tsyn(lat_t[:2])
        assert tuple(got.shape) == want.shape == (2, 32, 64, 3)
        _close(got, want, 1e-3, 1e-3)
    tsyn.set_bends({})


def test_render_patch_renders_lazy_noise_and_truncation(jax_draws, synths, rng):
    """A patch with every hook: ``get_truncation`` pulls toward the palette's
    mean row, ``get_noise`` slots hold None, arrays and a lazy module, and the
    render writes every frame; bends left by an earlier patch are cleared."""
    from ssar_tpu_torch.generate.noise import Loop

    _, tsyn = synths
    tsyn.set_bends({0: lambda x: x})
    psi = np.linspace(0.5, 1.0, T // 2).astype(np.float32)
    mod = types.SimpleNamespace(
        initialize=lambda args: args,
        get_latents=lambda sel, args: sel[torch.arange(args.n_frames) % sel.shape[0]],
        get_truncation=lambda args: psi,
        get_noise=lambda h, w, scale, num_scales, args: (
            None if scale == 0 else Loop(keys.PRNGKey(scale), args.n_frames, (h, w)) if scale % 2
            else torch.zeros(args.n_frames, h, w)))
    pal = rng.randn(5, 8, 512).astype(np.float32)

    class Sink:
        frames = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def write_i420(self, frame):
            Sink.frames += 1

    lat, noises = t_ar.render_patch(mod, AUDIO, SR, fps=FPS, palette=pal, synthesizer=tsyn, writer=Sink(),
                                    batch_size=7)
    assert tsyn.bends == {} and Sink.frames == T
    w_avg = pal.mean(0, keepdims=True)
    raw = pal[np.arange(T) % 5]
    psi_full = np.concatenate([psi, np.full(T - len(psi), psi[-1])])
    _close(lat, w_avg + psi_full[:, None, None] * (raw - w_avg), 1e-5, 1e-5)
    assert noises[0] is None and callable(noises[1]) and tuple(noises[2].shape) == (T, 1, 8, 8)


def test_render_patch_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = types.SimpleNamespace(get_latents=lambda sel, args: sel)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ar.render_patch(mod, AUDIO, SR, palette=np.zeros((2, 8, 512), np.float32))
