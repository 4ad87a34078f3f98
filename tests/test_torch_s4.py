"""The port's S4D modules and sashimi reactors vs the JAX package, on the CPU.

flax parameters (``jax.jit(model.init)``) are copied into the port with
``load_flax``; both packages get the same numpy inputs and, for the reactors,
the same injected base noise.  Tolerances: the S4D kernel and convolution at
rtol 1e-4 with an atol of 1e-5 of the output's scale (complex exp of the same
fp32 products, FFTs of another library); the stacked modules at rtol 1e-4 of
the output's scale, 1e-3 for the unguarded fixed decoder's latents (its
env / env.sum division magnifies round-off, see test_torch_models.py).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.models import s4 as t_s4
from ssar_tpu_torch.models._flax import flax_tree
from ssar_tpu_torch.models.backbones import S4Backbone, make_backbone
from ssar_tpu_torch.models.reactor import LatentNoiseReactor

j_s4 = importlib.import_module("ssar_tpu.models.s4")
j_backbones = importlib.import_module("ssar_tpu.models.backbones")
j_reactor = importlib.import_module("ssar_tpu.models.reactor")


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, *args, rngs=None):
    return _np(jax.jit(module.init)(rngs or jax.random.PRNGKey(0), *map(jnp.asarray, args)))


def _s4_params(rng, H, N):
    return dict(log_dt=np.log(rng.uniform(1e-3, 1e-1, H)).astype(np.float32),
                A_re=(-0.5 + 0.1 * rng.randn(H, N)).astype(np.float32),
                A_im=(np.pi * np.arange(N)[None].repeat(H, 0)).astype(np.float32),
                C_re=(rng.randn(H, N) * 0.5).astype(np.float32),
                C_im=(rng.randn(H, N) * 0.5).astype(np.float32),
                D=rng.randn(H).astype(np.float32))


def test_s4d_kernel_and_conv_match_jax(rng):
    H, N, L = 6, 8, 96
    p = _s4_params(rng, H, N)
    keys = ("log_dt", "A_re", "A_im", "C_re", "C_im")
    want_K = np.asarray(j_s4.s4d_kernel(*(jnp.asarray(p[k]) for k in keys), L))
    got_K = t_s4.s4d_kernel(*(torch.as_tensor(p[k]) for k in keys), L)
    np.testing.assert_allclose(got_K.numpy(), want_K, rtol=1e-4, atol=1e-5 * np.abs(want_K).max())
    u = rng.randn(2, L, H).astype(np.float32)
    want = j_s4.s4d_conv(jnp.asarray(u), jnp.asarray(want_K), jnp.asarray(p["D"]))
    got = t_s4.s4d_conv(torch.as_tensor(u), torch.as_tensor(want_K), torch.as_tensor(p["D"]))
    _close(got, want, 1e-4)


def test_s4d_step_matches_jax_and_conv(rng):
    H, N, L = 5, 6, 24
    p = _s4_params(rng, H, N)
    order = ("log_dt", "A_re", "A_im", "C_re", "C_im", "D")
    u = rng.randn(2, L, H).astype(np.float32)
    j_state = (jnp.zeros((2, H, N)), jnp.zeros((2, H, N)))
    t_state = (torch.zeros(2, H, N), torch.zeros(2, H, N))
    ys = []
    for t in range(L):
        j_state, j_y = j_s4.s4d_step(j_state, jnp.asarray(u[:, t]), *(jnp.asarray(p[k]) for k in order))
        t_state, t_y = t_s4.s4d_step(t_state, torch.as_tensor(u[:, t]), *(torch.as_tensor(p[k]) for k in order))
        _close(t_y, j_y, 1e-4)
        ys.append(t_y)
    # the recurrence is the convolution, step by step (the streaming contract)
    K = t_s4.s4d_kernel(*(torch.as_tensor(p[k]) for k in order[:5]), L)
    _close(torch.stack(ys, 1), t_s4.s4d_conv(torch.as_tensor(u), K, torch.as_tensor(p["D"])), 1e-4)


def test_s4d_layer_and_block_from_flax(rng):
    H, L = 8, 96
    x = rng.randn(2, L, H).astype(np.float32)
    jl = j_s4.S4DLayer(H, 16)
    v = _init(jl, x)
    tl = t_s4.S4DLayer(H, 16).load_flax(v["params"])
    with torch.no_grad():
        _close(tl(torch.as_tensor(x)), jl.apply(v, jnp.asarray(x)), 1e-4)

    jb = j_s4.S4Block(H, 16)
    v = _init(jb, x)
    tb = t_s4.S4Block(H, 16).load_flax(v["params"]).eval()
    with torch.no_grad():
        _close(tb(torch.as_tensor(x)), jb.apply(v, jnp.asarray(x)), 1e-4)
        # step mode through the block equals its convolution mode
        state = tb.init_state((2,))
        ys = []
        for t in range(L):
            state, y = tb.step(state, torch.as_tensor(x[:, t]))
            ys.append(y)
        _close(torch.stack(ys, 1), tb(torch.as_tensor(x)), 1e-4)
    # the flax tree round-trips through the port
    back = _np(jax.tree_util.tree_map(lambda t: t.numpy(), flax_tree(tb)))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b), back, v["params"])


def test_s4_backbone_from_flax(rng):
    H, L = 8, 96
    x = rng.randn(2, L, H).astype(np.float32)
    jm = j_backbones.S4Backbone(H, num_layers=3)
    v = _init(jm, x)
    tm = S4Backbone(H, num_layers=3).load_flax(v["params"]).eval()
    with torch.no_grad():
        _close(tm(torch.as_tensor(x)), jm.apply(v, jnp.asarray(x)), 1e-4)


def test_s4_block_dropout_from_generator(rng):
    x = torch.as_tensor(rng.randn(2, 32, 8).astype(np.float32))
    tb = t_s4.S4Block(8, 16, dropout=0.5).train()
    with torch.no_grad():
        a = tb(x, torch.Generator().manual_seed(3))
        b = tb(x, torch.Generator().manual_seed(3))
        c = tb(x, torch.Generator().manual_seed(4))
        d = tb.eval()(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_unported_backbones_raise():
    """Every key of the JAX package's BACKBONES is ported now; an unknown one raises."""
    for name in j_backbones.BACKBONES:
        module, flax_name = make_backbone(name, 8, 2)
        assert isinstance(module, torch.nn.Module) and flax_name.endswith("_0")
    with pytest.raises(ValueError, match="unknown backbone"):
        make_backbone("rwkv", 8, 2)


# ------------------------------------------------------------------ reactors --
def _reactor_pair(rng, decoder, B=2, T=96, H=4, layers=2, eps=0.0):
    F = 59
    feat = rng.randn(B, T, F).astype(np.float32)
    mean, std = feat.mean((0, 1)), feat.std((0, 1))
    palette = rng.randn(3 * H, 18, 512).astype(np.float32) if decoder == "fixed" else None
    kw = dict(backbone="sashimi", hidden_size=H, num_layers=layers, decoder=decoder, env_guard_eps=eps)
    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std),
                                      None if palette is None else jnp.asarray(palette), **kw)
    variables = _init(jm, feat, rngs={"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)})
    if decoder == "fixed" and not eps:  # lift the palette envelopes so their per-split sums stay away from 0
        out = variables["params"]["EnvelopeReactor_0"]["Dense_1"]
        out["bias"] = out["bias"] + np.where(np.arange(out["bias"].shape[0]) < 3 * H, 1.0, 0.0).astype(np.float32)
    tm = LatentNoiseReactor(mean, std, palette, **kw).load_flax(variables)
    base = [rng.randn(B, T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(4)]
    return feat, jm, variables, tm, base


@pytest.mark.parametrize("decoder,eps,rtol", [("fixed", 0.0, 1e-3), ("fixed", 0.5, 1e-4), ("learned", 0.0, 1e-4)])
def test_sashimi_reactor_from_flax_with_injected_noise(rng, monkeypatch, decoder, eps, rtol):
    feat, jm, variables, tm, base = _reactor_pair(rng, decoder, eps=eps)
    it = iter(base)
    monkeypatch.setattr(j_reactor, "_smoothed_noise", lambda key, bt, size, sigma=5.0: jnp.asarray(next(it)))
    j_lat, j_noise = jm.apply(variables, jnp.asarray(feat), rngs={"noise": jax.random.PRNGKey(3)})
    with torch.no_grad():
        t_lat, t_noise = tm.eval()(torch.as_tensor(feat), base_noise=base)
    assert t_lat.shape == (2, 96, 18, 512)
    _close(t_lat, j_lat, rtol)
    for got, want in zip(t_noise, j_noise):
        _close(got, want, 1e-4)


def test_default_backbone_matches_jax():
    """Neither package is told a backbone: both build the sashimi reactor."""
    mean, std, palette = np.zeros(59, np.float32), np.ones(59, np.float32), np.zeros((36, 18, 512), np.float32)
    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(palette), hidden_size=12)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 59)))["params"]
    tm = LatentNoiseReactor(mean, std, palette, hidden_size=12)
    mine = jax.tree_util.tree_map(lambda t: tuple(t.shape), flax_tree(tm))
    theirs = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    assert mine == theirs
    assert "S4Backbone_0" in mine["EnvelopeReactor_0"]
