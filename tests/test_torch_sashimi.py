"""The port's Sashimi U-Net and its streaming mode vs the JAX package, on the CPU.

flax parameters (perturbed) go into the port through ``load_flax``.  The S4
blocks take the plain complex kernel here (B3 only on a CUDA tensor).
Tolerances, of the largest magnitude: the forward, the gradients and the
streamer against the conv mode at 1e-4 (the JAX test's own bound); dropout
with JAX's recorded masks at 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.models._flax import flax_tree
from ssar_tpu_torch.models.sashimi import DownPool, Sashimi, SashimiStreamer, UpPool
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import close, init, perturb, record_bernoulli, replay_bernoulli, tree_close

js = importlib.import_module("ssar_tpu.models.sashimi")

H, B, T = 8, 2, 32
KW = dict(n_layers_per_tier=1, n_tiers=2, pool=4, expand=2, state_dim=8)


def _pair(rng, dropout=0.0, scale=0.1):
    jm = js.Sashimi(H, dropout=dropout, **KW)
    x = rng.randn(B, T, H).astype(np.float32)
    params = init(jm, x)["params"]
    params = jax.tree_util.tree_map(lambda a: a, params)
    # perturb only the dense parts: the S4 parameters keep their stable init
    for name, sub in params.items():
        if "pools" in name or name == "out_norm":
            params[name] = perturb(sub, rng, scale)
    tm = Sashimi(H, dropout=dropout, **KW).load_flax(params)
    return jm, params, tm, x


def test_sashimi_forward_and_gradients_match_jax(rng):
    jm, params, tm, x = _pair(rng)
    r = rng.randn(B, T, H).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * r)))(params)
    got = tm.eval()(torch.as_tensor(x))
    close(got, want, 1e-4, "forward")
    (got * torch.as_tensor(r)).sum().backward()
    tree_close(flax_tree(tm, grad=True), grads, 1e-4, "grad")


def test_sashimi_dropout_with_jax_draws(rng, monkeypatch):
    jm, params, tm, x = _pair(rng, dropout=0.25)
    draws = record_bernoulli(monkeypatch)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v, deterministic=False,
                                         rngs={"dropout": jax.random.PRNGKey(4)}))(params, jnp.asarray(x))
    jax.effects_barrier()
    assert len(draws) == 5   # one mask per S4 block: 2 tiers x (down + up) + the centre's
    left = replay_bernoulli(monkeypatch, draws)
    with torch.no_grad():
        got = tm.train()(torch.as_tensor(x))
    assert next(left, None) is None
    close(got, want, 1e-4, "dropout")


def test_pools_match_jax(rng):
    x = rng.randn(B, 12, H).astype(np.float32)
    jd, ju = js.DownPool(2 * H, 4), js.UpPool(H, 4)
    pd, pu = perturb(init(jd, x)["params"], rng), perturb(init(ju, x)["params"], rng)
    td, tu = DownPool(H, 2 * H, 4).load_flax(pd), UpPool(H, H, 4).load_flax(pu)
    with torch.no_grad():
        close(td(torch.as_tensor(x)), jd.apply({"params": pd}, jnp.asarray(x)), 1e-5, "down")
        up = tu(torch.as_tensor(x))
        close(up, ju.apply({"params": pu}, jnp.asarray(x)), 1e-5, "up")
    assert torch.equal(up[:, :4], torch.zeros(B, 4, H))   # the causal shift by one pooled frame


@pytest.mark.parametrize("n_tiers", (1, 2))
def test_streamer_equals_conv_mode(rng, n_tiers):
    kw = dict(KW, n_tiers=n_tiers)
    tm = Sashimi(H, **kw).eval()
    x = torch.as_tensor(rng.randn(B, T, H).astype(np.float32))
    with torch.no_grad():
        want = tm(x)
    streamer = SashimiStreamer(tm, batch_size=B)
    got = torch.stack([streamer.step(x[:, t]) for t in range(T)], dim=1)
    close(got, want.numpy(), 1e-4, "streamer")


def test_streamer_matches_jax_streamer(rng):
    jm, params, tm, x = _pair(rng)
    js_stream = js.SashimiStreamer(jm, {"params": params}, batch_size=B)
    ts_stream = SashimiStreamer(tm.eval(), batch_size=B)
    for t in range(4):
        close(ts_stream.step(torch.as_tensor(x[:, t])), js_stream.step(jnp.asarray(x[:, t])), 1e-4, f"frame {t}")
