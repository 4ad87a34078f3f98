"""Port StyleGAN2 / render vs the JAX package, on the CPU, in float32.

The same JAX parameter pytree goes through ``params_from_jax``; noises and
latents are the same numpy arrays.  Images are held at rtol 1e-5 of their
scale (convolutions summed in another order); I420 packing is bit-exact.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.gan.render import render_latents_to_video, rgb_to_i420
from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer, load_npz

js = importlib.import_module("ssar_tpu.gan.stylegan2")
j_render = importlib.import_module("ssar_tpu.gan.render")
j_convert = importlib.import_module("ssar_tpu.gan.convert")

CALIBRATION_G = Path(__file__).resolve().parents[1] / "docs" / "study" / "calibration_g.npz"


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _jax_params(config, rng):
    """Random JAX init with non-zero noise weights and biases, so every term is exercised."""
    p = jax.tree_util.tree_map(np.asarray, js.init_generator(jax.random.PRNGKey(0), config))
    for layer in [p["conv1"], p["to_rgb1"], *p["convs"], *p["to_rgbs"]]:
        layer["bias"] = layer["bias"] + 0.1 * rng.randn(*layer["bias"].shape).astype(np.float32)
        if "noise_weight" in layer:
            layer["noise_weight"] = np.float32(rng.randn())
    return p


@pytest.mark.parametrize("s2d", [False, True])
def test_synthesis_matches_jax(rng, s2d):
    cfg = dict(resolution=64, max_channels=32)  # final level below 128 channels: JAX takes its s2d form
    jc, tc = js.StyleGAN2Config(**cfg), ts.StyleGAN2Config(**cfg)
    p = _jax_params(jc, rng)
    lat = rng.randn(2, jc.n_latent, 512).astype(np.float32)
    noises = [rng.randn(2, h, w, 1).astype(np.float32) for h, w in jc.noise_shapes()]
    want = js.synthesis(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(lat),
                        [jnp.asarray(n) for n in noises], jc, s2d=s2d)
    got = ts.synthesis(ts.params_from_jax(p), torch.as_tensor(lat), [torch.as_tensor(n) for n in noises], tc)
    assert tuple(got.shape) == want.shape == (2, 64, 64, 3)
    _close(got, want)


def test_synthesis_early_exit_and_mapping(rng):
    jc, tc = js.StyleGAN2Config(resolution=32, max_channels=16), ts.StyleGAN2Config(resolution=32, max_channels=16)
    p = _jax_params(jc, rng)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), ts.params_from_jax(p)
    lat = rng.randn(2, jc.n_latent, 512).astype(np.float32)
    _close(ts.synthesis(tp, torch.as_tensor(lat), None, tc, output_size=8),
           js.synthesis(jp, jnp.asarray(lat), None, jc, output_size=8, s2d=False))
    z = rng.randn(3, 512).astype(np.float32)
    _close(ts.mapping(tp, torch.as_tensor(z), tc), js.mapping(jp, jnp.asarray(z), jc))


def test_calibration_checkpoint_matches_jax(rng):
    """The committed trained generator, at its own config (256 px, 128 channels)."""
    jc = js.StyleGAN2Config(resolution=256, max_channels=128)
    tc = ts.StyleGAN2Config(resolution=256, max_channels=128)
    lat = rng.randn(1, jc.n_latent, 512).astype(np.float32)
    want = js.synthesis(j_convert.load_npz(str(CALIBRATION_G)), jnp.asarray(lat), None, jc, s2d=False)
    got = ts.synthesis(load_npz(str(CALIBRATION_G)), torch.as_tensor(lat), None, tc)
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 16, 16, 3)])
def test_rgb_to_i420_bit_exact(rng, shape):
    frames = rng.uniform(-0.1, 1.1, size=shape).astype(np.float32)
    got = rgb_to_i420(torch.as_tensor(frames)).numpy()
    want = np.asarray(j_render.rgb_to_i420(jnp.asarray(frames)))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


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


def test_render_loop_writes_every_frame(rng):
    cfg = ts.StyleGAN2Config(resolution=16, max_channels=8)
    syn = StyleGAN2Synthesizer(config=cfg, seed=0, dtype=torch.float32, device="cpu")
    lat = torch.as_tensor(rng.randn(11, cfg.n_latent, 512).astype(np.float32))
    noise = [torch.as_tensor(rng.randn(11, 1, h, w).astype(np.float32)) for h, w in cfg.noise_shapes()]
    sink = render_latents_to_video(syn, lat, noise, batch_size=4, writer=_Sink())
    assert len(sink.frames) == 11 and sink.frames[0].shape == (24, 16)
    want = rgb_to_i420((syn(lat, noises=[n.permute(0, 2, 3, 1) for n in noise]) + 1) / 2).numpy()
    np.testing.assert_array_equal(np.stack(sink.frames), want)
