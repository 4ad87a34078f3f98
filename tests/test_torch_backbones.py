"""The port's reactor backbones and the 3-D-conv noise pyramid vs the JAX package, on the CPU.

flax parameters (perturbed, so that zero biases and the 1e-6 layerscale take
part) go into the port through ``load_flax``; both packages get the same
seeded numpy inputs.  Dropout, drop-path and the LSTM's locked masks are
JAX's own draws, recorded from ``jax.random.bernoulli`` and replayed through
``ssar_tpu_torch.generate.keys.bernoulli``.  Tolerances, of the output's (or
the gradient tree's) largest magnitude: 1e-5 for the feed-forward
backbones, 1e-4 for the recurrent and attention ones and for gradients.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.models import backbones as tb
from ssar_tpu_torch.models._flax import flax_tree
from ssar_tpu_torch.models.reactor import ConvNoiseUpsampler, LatentNoiseReactor
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import close, init, perturb, record_bernoulli, replay_bernoulli, tree_close

jb = importlib.import_module("ssar_tpu.models.backbones")
j_reactor = importlib.import_module("ssar_tpu.models.reactor")

H, L, B = 16, 24, 2
NEW = ("lstm", "conv", "mlp", "transformer")
FWD_RTOL = {"gru": 1e-4, "lstm": 1e-4, "conv": 1e-5, "mlp": 1e-5, "transformer": 1e-4}


def _pair(rng, name, dropout=0.0, layers=2):
    jm = jb.BACKBONES[name](H, layers, dropout)
    x = rng.randn(B, L, H).astype(np.float32)
    params = perturb(init(jm, x)["params"], rng)
    tm, _ = tb.make_backbone(name, H, layers, dropout)
    tm.load_flax(params)
    return jm, params, tm, x


@pytest.mark.parametrize("name", ("gru",) + NEW)
def test_backbone_forward_matches_jax(rng, name):
    jm, params, tm, x = _pair(rng, name)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x))
    close(got, want, FWD_RTOL[name], name)


@pytest.mark.parametrize("name", ("gru",) + NEW)
def test_backbone_gradients_match_jax(rng, name):
    jm, params, tm, x = _pair(rng, name)
    r = rng.randn(B, L, H).astype(np.float32)
    loss, grads = jax.value_and_grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * r))(params)
    got = (tm.eval()(torch.as_tensor(x)) * torch.as_tensor(r)).sum()
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-4 * abs(float(loss))
    tree_close(flax_tree(tm, grad=True), grads, 1e-4, name)


@pytest.mark.parametrize("name", NEW)
def test_backbone_dropout_with_jax_draws(rng, monkeypatch, name):
    """Training mode at dropout 0.3 (the LSTM's three locked masks, the
    recurrent one stepped in a loop; ConvNeXt's drop-path; the MLP's and the
    transformer's dropout), with JAX's masks."""
    jm, params, tm, x = _pair(rng, name, dropout=0.3)
    draws = record_bernoulli(monkeypatch)
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(5)})
    assert draws, "JAX drew no mask"
    left = replay_bernoulli(monkeypatch, draws)
    with torch.no_grad():
        got = tm.train()(torch.as_tensor(x))
    assert next(left, None) is None, "the port drew fewer masks than JAX"
    close(got, want, FWD_RTOL[name], name)


def test_lstm_loop_equals_cudnn_path(rng):
    """The stepped cell (used under a recurrent mask) with an all-ones mask
    is the ``nn.LSTM`` path."""
    layer = tb.VariationalLSTM(H, H)
    x = torch.as_tensor(rng.randn(B, L, H).astype(np.float32))
    with torch.no_grad():
        close(layer._masked_steps(x, torch.ones(B, H)), layer.lstm(x)[0].numpy(), 1e-6)


def test_alibi_bias_matches_jax():
    np.testing.assert_array_equal(tb.alibi_bias(4, 9), jb.alibi_bias(4, 9))


@pytest.mark.parametrize("name", ("gru",) + NEW + ("sashimi",))
def test_make_backbone_builds_every_key_with_flax_names(name):
    """Each key's reactor exports a tree of the JAX reactor's structure and shapes."""
    mean, std = np.zeros(59, np.float32), np.ones(59, np.float32)
    palette = np.zeros((3 * 8, 18, 512), np.float32)
    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(palette), backbone=name,
                                      hidden_size=8, num_layers=2)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 16, 59)))["params"]
    tm = LatentNoiseReactor(mean, std, palette, backbone=name, hidden_size=8, num_layers=2)
    mine = jax.tree_util.tree_map(lambda t: tuple(t.shape), flax_tree(tm))
    assert mine == jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)


def _upsampler_pair(rng, D=4, T=4):
    jm = j_reactor.ConvNoiseUpsampler(D)
    x = rng.randn(B, T, D).astype(np.float32)
    params = perturb(init(jm, x)["params"], rng)
    return jm, params, ConvNoiseUpsampler(D, D).load_flax(params), x


def test_conv_noise_upsampler_matches_jax(rng):
    jm, params, tm, x = _upsampler_pair(rng)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    assert [tuple(g.shape) for g in got] == [(B, 4, s, s) for s in (4, 8, 16, 32)]
    for g, w in zip(got, want):
        close(g, w, 1e-5, "noise")
    r = [rng.randn(*np.shape(w)).astype(np.float32) for w in want]
    grads = jax.jit(jax.grad(lambda p: sum(jnp.sum(n * q) for n, q in zip(jm.apply({"params": p}, jnp.asarray(x)),
                                                                          r))))(params)
    sum((n * torch.as_tensor(q)).sum() for n, q in zip(tm(torch.as_tensor(x)), r)).backward()
    tree_close(flax_tree(tm, grad=True), grads, 1e-4, "upsampler")


def test_conv3d_learned_reactor_matches_jax(rng):
    """The learned decoder with ``noise_mode="conv3d"`` (the transformer
    backbone): latents and the content-generated noise pyramid."""
    T, F = 8, 59
    feat = rng.randn(B, T, F).astype(np.float32)
    mean, std = feat.mean((0, 1)), feat.std((0, 1))
    kw = dict(backbone="transformer", hidden_size=8, num_layers=1, decoder="learned", noise_mode="conv3d")
    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std), **kw)
    variables = init(jm, feat, rngs={"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)})
    tm = LatentNoiseReactor(mean, std, **kw).load_flax(variables).eval()
    j_lat, j_noise = jax.jit(jm.apply)(variables, jnp.asarray(feat), rngs={"noise": jax.random.PRNGKey(3)})
    with torch.no_grad():
        t_lat, t_noise = tm(torch.as_tensor(feat))
    close(t_lat, j_lat, 1e-4, "latents")
    for g, w in zip(t_noise, j_noise):
        close(g, w, 1e-4, "noise")
