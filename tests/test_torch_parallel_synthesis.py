"""The port's channel-parallel synthesis (``parallel/synthesis_tp.py``) and
frame-sharded render (``gan/render.py``) on gloo process groups of 2 and 4
CPU ranks, against one process and against the JAX package.

Tolerances:
- ``synthesize_tp`` at 32 px, float32, within 1e-4 absolute of the port's
  ``synthesis`` (convolutions over fewer output channels may sum in another
  order) and within 1e-3 of JAX's ``synthesis`` on the same weights (the
  bound of tests/test_parallel.py); on one device equal to ``synthesis``;
- the frame-sharded render at world size 2 against world size 1: every I420
  byte within one level, at most 1 % of them off by one (the synthesis of a
  smaller batch rounds differently at quantisation edges); a batch the ranks
  do not divide is rendered whole on each, and rank 0's frames are equal.
"""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.parallel import launch, mesh as t_mesh
from ssar_tpu_torch.parallel.synthesis_tp import shard_generator_params, synthesize_tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

js = importlib.import_module("ssar_tpu.gan.stylegan2")


# ----------------------------------------------------------------- synthesis --
def _generator(resolution=32):
    config = ts.StyleGAN2Config(resolution=resolution)
    params = ts.init_generator(config, torch.Generator().manual_seed(0))
    for p in [params["conv1"], *params["convs"]]:   # noise and bias take part
        p["noise_weight"] = torch.tensor(0.3)
        p["bias"] = torch.randn(p["bias"].shape, generator=torch.Generator().manual_seed(1)) * 0.1
    return config, params


def test_shard_generator_params_follows_the_jax_rule():
    config, params = _generator()
    grid = t_mesh.make_mesh((1, 1), ("data", "tp"), device="cpu")
    assert torch.equal(shard_generator_params(params, grid)["const"], params["const"])

    class Quarter:   # rank 1 of a (1, 4) mesh, without a group
        mesh_dim_names = ("data", "tp")

        def size(self, dim=None):
            return (1, 4)[dim] if dim is not None else 4

        def get_local_rank(self, name):
            return {"data": 0, "tp": 1}[name]

    local = shard_generator_params(params, Quarter())
    assert local["const"].shape == (128, 4, 4) and torch.equal(local["const"], params["const"][128:256])
    assert local["convs"][0]["weight"].shape[0] == params["convs"][0]["weight"].shape[0] // 4
    assert local["to_rgb1"]["weight"] is params["to_rgb1"]["weight"]   # 3 output channels: replicated
    assert local["conv1"]["bias"] is params["conv1"]["bias"]           # a vector: replicated
    assert local["mapping"][0]["weight"] is params["mapping"][0]["weight"]


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_synthesize_tp_matches_synthesis_and_jax(grid):
    config, params = _generator()
    B = 4
    g = torch.Generator().manual_seed(2)
    lat = torch.randn((B, config.n_latent, 512), generator=g)
    noises = [torch.randn((B, h, w, 1), generator=g) for h, w in config.noise_shapes()]
    noises[3] = None
    out = launch.run(4, synthesize_tp, params, lat, noises, config, dtype=torch.float32,
                     mesh=(grid, ("data", "tp")))
    for r in out[1:]:
        np.testing.assert_array_equal(r, out[0])
    ref = ts.synthesis(params, lat, noises, config).numpy()
    assert out[0].shape == ref.shape == (B, 32, 32, 3)
    assert np.abs(out[0] - ref).max() <= 1e-4
    jp = jax.tree_util.tree_map(jnp.asarray, ts.params_to_jax(params))
    jn = [None if n is None else jnp.asarray(n.numpy()) for n in noises]
    want = np.asarray(js.synthesis(jp, jnp.asarray(lat.numpy()), jn, js.StyleGAN2Config(resolution=32)))
    assert np.abs(out[0] - want).max() < 1e-3


def test_synthesize_tp_on_one_device_is_synthesis():
    config, params = _generator()
    lat = torch.randn((2, config.n_latent, 512), generator=torch.Generator().manual_seed(5))
    grid = t_mesh.make_mesh((1, 1), ("data", "tp"), device="cpu")
    got = synthesize_tp(params, lat, None, config, grid, dtype=torch.float32)
    assert torch.equal(got, ts.synthesis(params, lat, None, config))


# -------------------------------------------------------------------- render --
@pytest.mark.parametrize("batch_size,exact", [(4, False), (3, True)])
def test_frame_sharded_render_matches_one_rank(batch_size, exact):
    """7 frames: batches of 4 leave a last batch of 3 to pad (rank 1's second
    slice is frame 6 and a pad row); batches of 3 do not divide over 2 ranks
    and are rendered whole on each (one warning), so rank 0's frames are
    exactly one process's."""
    config = ts.StyleGAN2Config(resolution=32, max_channels=32)
    params = ts.init_generator(config, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(4)
    T = 7
    latents = rng.randn(T, config.n_latent, 512).astype(np.float32)
    bank = rng.randn(T, 1, 4, 4).astype(np.float32)
    modulation = np.linspace(-0.5, 0.5, T).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = W.render(params, 32, latents, bank, modulation, batch_size)
    out = launch.run(2, W.render, params, 32, latents, bank, modulation, batch_size)
    assert out[1] == [] and len(out[0]) == len(one) == T   # rank 1 writes nothing
    got, want = np.stack(out[0]).astype(int), np.stack(one).astype(int)
    assert got.shape == want.shape == (T, 48, 32)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())
