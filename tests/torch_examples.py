"""Shared parts of the example patches' parity tests: the track, JAX's draws
in ``keys``, one 32 px synthesizer in both packages, and one comparison of
a JAX example with its port through ``render_patch``.

Tolerances: latents, every noise slot and bent frames within 1e-3 (the
docs/PARITY.md budget of the chroma and tonnetz groups the envelopes mix);
every noise slot's population std within 1e-4 of JAX's, relative: an
N - 1 ``torch.std`` is 1/(2N) off, 6.5e-4 on a 48-frame 4 x 4 slot, which
the 1e-3 value tolerance would let through.  B1's launches: the calls of the
median filter on the CPU equal ``chip_smoke.EXAMPLE_B1``, the count the card
is held to.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ssar_tpu_torch import examples
from ssar_tpu_torch.audio import segment, spectral
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
CFG = dict(resolution=32, max_channels=16)
# 4 s at 12 fps (T = 48), the track of tests/test_torch_optimize.py on which both packages' tuning estimates and CQT
# labels agree
AUDIO = chip_smoke.two_part_track(SR)
T = len(AUDIO) // 1024


def close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.fixture
def jax_draws(monkeypatch):
    """``keys`` replaced by wrappers over ``jax.random``: JAX's draws exactly."""
    monkeypatch.setattr(keys, "PRNGKey", jax.random.PRNGKey)
    monkeypatch.setattr(keys, "split", lambda key, num=2: tuple(jax.random.split(key, num)))
    monkeypatch.setattr(keys, "normal", lambda key, shape=(), device=None:
                        torch.as_tensor(np.array(jax.random.normal(key, tuple(shape))), device=device))


@pytest.fixture(scope="module")
def synths():
    """A JAX synthesizer at 32 px in float32 and the port's on its weights,
    every noise weight 0.5 so that the noise takes part in the frames."""
    jsyn = j_wrap.StyleGAN2Synthesizer(config=js.StyleGAN2Config(**CFG), dtype=jnp.float32, seed=1)
    params = jax.tree_util.tree_map(np.asarray, jsyn.params)
    for layer in [params["conv1"], *params["convs"]]:
        layer["noise_weight"] = np.float32(0.5)
    jsyn.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsyn = t_wrap.StyleGAN2Synthesizer(config=ts.StyleGAN2Config(**CFG), dtype=torch.float32, device="cpu",
                                       params=ts.params_from_jax(params))
    return jsyn, tsyn


def noise_at(n, T_):
    """A noise slot as a (T, H, W) array: lazy modules evaluated over the
    whole track."""
    if n is None:
        return None
    if callable(n) and not isinstance(n, (np.ndarray, jax.Array, torch.Tensor)):
        n = n(0, T_)
    n = np.asarray(n.detach().numpy() if isinstance(n, torch.Tensor) else n)
    return n[:, 0] if n.ndim == 4 else n


def run_example(name, synths, rng, monkeypatch, audio_file=None):
    """One JAX example and its port through ``render_patch`` on the same
    track, palette and weights: latents, every noise slot (None where JAX's
    is None), each slot's std, bent frames (with the patch's noise, at two
    frames inside the scroll where a bend is animated), the median filter's
    calls against ``chip_smoke.EXAMPLE_B1``.  Returns the port's
    (latents, noises)."""
    jsyn, tsyn = synths
    j_mod = j_ar.load_patch_module(str(ROOT / "examples" / f"{name}.py"))
    t_mod = t_ar.load_patch_module(examples.path(name))
    pal = rng.randn(12, jsyn.config.n_latent, 512).astype(np.float32)
    lat_j, noise_j = j_ar.render_patch(j_mod, jnp.asarray(AUDIO), SR, fps=FPS, palette=jnp.asarray(pal),
                                       synthesizer=jsyn, audio_file=audio_file)
    filtered = []
    with monkeypatch.context() as m:
        for module in (spectral, segment):
            real = module.median_filter
            m.setattr(module, "median_filter", lambda *a, real=real, **kw: filtered.append(1) or real(*a, **kw))
        lat_t, noise_t = t_ar.render_patch(t_mod, AUDIO, SR, fps=FPS, palette=pal, synthesizer=tsyn,
                                           audio_file=audio_file)
    assert len(filtered) == chip_smoke.EXAMPLE_B1[name][audio_file is not None], name

    assert tuple(lat_t.shape) == lat_j.shape == (T, jsyn.config.n_latent, 512)
    close(lat_t, lat_j, 1e-3, 1e-3)
    slots = []
    if noise_j is None:
        assert noise_t is None
    else:
        assert len(noise_t) == len(noise_j) == tsyn.n_noises_used
        for a, b in zip(noise_t, noise_j):
            a, b = noise_at(a, T), noise_at(b, T)
            assert (a is None) == (b is None)
            if b is not None:
                close(a, b, 1e-3, 1e-3)
                np.testing.assert_allclose(a.std(dtype=np.float64), np.asarray(b).std(dtype=np.float64), rtol=1e-4)
            slots.append((a, b))
    if tsyn.bends:
        frames = np.arange(2)
        if tsyn.bend_mods:   # two frames the animated bend moves
            mod = np.asarray(next(iter(jsyn.bend_mods.values())))
            frames = np.argsort(-mod, kind="stable")[:2]
        nj = nt = None
        if slots:
            nj = [None if b is None else jnp.asarray(b[frames][..., None]) for _, b in slots]
            nt = [None if a is None else torch.as_tensor(a[frames][..., None]) for a, _ in slots]
        want = jsyn(lat_j[frames], frame_idx=jnp.asarray(frames), noises=nj)
        got = tsyn(lat_t[frames], frame_idx=torch.as_tensor(frames), noises=nt)
        assert tuple(got.shape) == want.shape
        close(got, want, 1e-3, 1e-3)
    tsyn.set_bends({})
    return lat_t, noise_t
