"""Helpers of the port's parity tests: flax parameters into the port, JAX's
random draws into ``ssar_tpu_torch.generate.keys``, tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.generate import keys


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: the test suite runs six
    workers on the host's cores, and torch's thread pools then wait on each
    other (a small conv1d backward ran 300x slower at 8 threads a worker).
    Autouse in every module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol, what="", scale=None):
    """|got - want| <= rtol * max |want| (or rtol * scale) everywhere."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if scale is None else scale, 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, f"{what}: max error {err:.3g} > {rtol:g} x {scale:.3g}"


def tree_close(got: dict, want: dict, rtol, what="", per_leaf: bool = False):
    """Two trees of the same structure, leaf by leaf, within rtol of the
    whole tree's largest magnitude (of each leaf's with ``per_leaf``): a
    gradient that is zero in exact arithmetic (a key bias under softmax) is
    round-off in both packages."""
    g = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
        lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t), got,
        is_leaf=torch.is_tensor))[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w], what
    scale = None if per_leaf else max(float(np.abs(np.asarray(b)).max()) for _, b in w)
    for (path, a), (_, b) in zip(g, w):
        close(a, b, rtol, f"{what}{jax.tree_util.keystr(path)}", scale)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def init(module, *args, rngs=None, **kwargs):
    """flax variables of `module` as numpy arrays."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)} if rngs is None else rngs
    arrays = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    return np_tree(jax.jit(lambda r, *a: module.init(r, *a, **kwargs))(rngs, *arrays))


def perturb(tree, rng, scale: float = 0.3):
    """Every leaf plus scaled noise, so that zero-initialised biases, gates
    and layerscales take part in the comparison."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.randn(*np.shape(a)) * max(1.0, float(np.abs(a).std())))
        .astype(np.float32), tree)


def record_bernoulli(monkeypatch) -> list:
    """Record every ``jax.random.bernoulli`` draw, in order (inside scans
    and jits through an ordered debug callback)."""
    draws, real = [], jax.random.bernoulli

    def recording(key, p=0.5, shape=None, **kw):
        out = real(key, p, shape, **kw)
        if isinstance(out, jax.core.Tracer):
            jax.debug.callback(lambda m: draws.append(np.asarray(m)), out, ordered=True)
        else:
            draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    return draws


def replay_bernoulli(monkeypatch, draws: list):
    """``keys.bernoulli`` hands back `draws` in order (shapes checked)."""
    it = iter(list(draws))

    def replay(generator, p, shape, device=None):
        m = next(it)
        assert m.shape == tuple(shape), (m.shape, tuple(shape))
        return torch.as_tensor(np.array(m), device=device)

    monkeypatch.setattr(keys, "bernoulli", replay)
    return it


def _t(a, device=None):
    return torch.as_tensor(np.array(a), device=device)


def jax_keys(monkeypatch):
    """``keys`` replaced by wrappers over ``jax.random``: JAX's draws exactly."""
    monkeypatch.setattr(keys, "PRNGKey", jax.random.PRNGKey)
    monkeypatch.setattr(keys, "split", lambda key, num=2: tuple(jax.random.split(key, num)))
    monkeypatch.setattr(keys, "fold_in", jax.random.fold_in)
    monkeypatch.setattr(keys, "normal", lambda key, shape=(), device=None:
                        _t(jax.random.normal(key, tuple(shape)), device))
    monkeypatch.setattr(keys, "uniform", lambda key: float(jax.random.uniform(key)))

    def randint(key, lo, hi, shape=None, device=None):
        if shape is None:
            return int(jax.random.randint(key, (), lo, hi))
        return _t(jax.random.randint(key, tuple(shape), lo, hi), device).long()

    monkeypatch.setattr(keys, "randint", randint)
    monkeypatch.setattr(keys, "permutation", lambda key, n: _t(jax.random.permutation(key, n)).long())
