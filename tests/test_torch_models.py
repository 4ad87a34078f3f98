"""Port reactor vs the flax reactor, on the CPU, from the same numpy inputs.

flax parameters are converted into the port (``load_flax``) and both sides
get the same injected base noise (JAX's random stream cannot be reproduced
in torch).  float32, rtol 1e-5 of the output scale for the GRU backbone.
The unguarded fixed decoder divides by each split's envelope sum, which
magnifies float32 round-off near sum = 0: it is held at rtol 1e-4 on inputs
whose sums stay away from 0 (checked), and the guarded decoder
(env_guard_eps > 0) at rtol 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.models.backbones import MultiLayerRNN
from ssar_tpu_torch.models.reactor import LatentNoiseReactor

j_backbones = importlib.import_module("ssar_tpu.models.backbones")
j_reactor = importlib.import_module("ssar_tpu.models.reactor")


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_gru_backbone_from_flax(rng):
    x = rng.randn(2, 20, 6).astype(np.float32)
    jm = j_backbones.MultiLayerRNN(6, num_layers=3)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = MultiLayerRNN(6, num_layers=3)
    tm.load_flax(jax.tree_util.tree_map(np.asarray, v)["params"])
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    _close(got, jm.apply(v, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("eps,rtol", [(0.0, 1e-4), (0.5, 1e-5)])
def test_reactor_from_flax_with_injected_noise(rng, monkeypatch, eps, rtol):
    B, T, F, H, L = 2, 24, 59, 4, 3
    feat = rng.randn(B, T, F).astype(np.float32)
    mean, std = feat.mean((0, 1)), feat.std((0, 1))
    palette = rng.randn(3 * H, 18, 512).astype(np.float32)
    base = [rng.randn(B, T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(4)]

    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(palette), backbone="gru",
                                      hidden_size=H, num_layers=L, env_guard_eps=eps)
    variables = jm.init({"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, jnp.asarray(feat))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if not eps:  # lift the palette envelopes so their per-split sums stay away from 0
        out = variables["params"]["EnvelopeReactor_0"]["Dense_1"]
        out["bias"] = out["bias"] + np.where(np.arange(out["bias"].shape[0]) < 3 * H, 1.0, 0.0).astype(np.float32)
    it = iter(base)
    monkeypatch.setattr(j_reactor, "_smoothed_noise", lambda key, bt, size, sigma=5.0: jnp.asarray(next(it)))
    j_lat, j_noise = jm.apply(variables, jnp.asarray(feat), rngs={"noise": jax.random.PRNGKey(3)})

    tm = LatentNoiseReactor(mean, std, palette, backbone="gru", hidden_size=H, num_layers=L, env_guard_eps=eps)
    tm.load_flax(variables)
    with torch.no_grad():
        env = tm(torch.as_tensor(feat), return_envelopes=True)
        t_lat, t_noise = tm(torch.as_tensor(feat), base_noise=base)
    if not eps:
        assert float(env[..., : 3 * H].reshape(B, T, 3, H).sum(-1).abs().min()) > 0.5
    _close(t_lat, j_lat, rtol)
    for got, want in zip(t_noise, j_noise):
        _close(got, want, 1e-5)


def test_reactor_draws_noise_from_generator():
    tm = LatentNoiseReactor(np.zeros(5), np.ones(5), np.zeros((6, 18, 512)), hidden_size=2, num_layers=1)
    x = torch.randn(1, 16, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, n1 = tm(x, generator=torch.Generator().manual_seed(7))
        _, n2 = tm(x, generator=torch.Generator().manual_seed(7))
    assert [tuple(n.shape) for n in n1] == [(1, 16, s, s) for s in (4, 8, 16, 32)]
    assert all(torch.equal(a, b) for a, b in zip(n1, n2))


def test_reactor_rejects_unported_decoders():
    # both learned-decoder noise modes are ported (the 3-D-conv pyramid too); unknown ones raise
    model = LatentNoiseReactor(np.zeros(5), np.ones(5), decoder="learned", noise_mode="conv3d", hidden_size=4)
    with torch.no_grad():
        _, noise = model(torch.zeros(1, 3, 5))
    assert [tuple(n.shape) for n in noise] == [(1, 3, s, s) for s in (4, 8, 16, 32)]
    with pytest.raises(ValueError):
        LatentNoiseReactor(np.zeros(5), np.ones(5), decoder="learned", noise_mode="other")
    with pytest.raises(ValueError):
        LatentNoiseReactor(np.zeros(5), np.ones(5), np.zeros((6, 18, 512)), decoder="other")
