"""The in-environment calibration generator: train StyleGAN2's synthesis so
W latents acquire a distinct, palette-like visual identity.

Counterpart of ``ssar_tpu/train/palette_g.py``: procedural targets that are
smooth functions of W (two palette colours, a stripe field, a Gaussian blob;
``u = tanh(2 P w)`` through a fixed seeded projection P), an MSE anchor and a
small hinge-adversarial term against the port's ``Discriminator`` with R1 (a
double backward).  The mapping stays frozen: W is detached and only the
synthesis parameters are in the optimizer.  Synthesis runs in bf16, as in the
JAX package.  The JAX package's ``lax.scan`` chunks of (D step, G step) pairs
are a plain loop; the z draws thread ``generate/keys.py`` keys as the JAX
package folds its.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..gan import stylegan2 as sg
from ..gan.discriminator import Discriminator
from ..generate import keys
from ..generate.latent import linspace
from ..utils.device import resolve_device


def target_basis(style_dim: int = 512, seed: int = 123, device=None) -> torch.Tensor:
    """The fixed seeded projection W -> 12 pattern controls (12, style_dim)."""
    rs = np.random.RandomState(seed)
    return torch.as_tensor((rs.randn(12, style_dim) / np.sqrt(style_dim)).astype(np.float32), device=device)


def procedural_targets(w: torch.Tensor, P: torch.Tensor, size: int = 256) -> torch.Tensor:
    """W (B, 512) -> structured colour images (B, size, size, 3) in [-1, 1]."""
    u = torch.tanh(2.0 * w @ P.T)
    c1, c2 = 0.9 * u[:, 0:3], 0.9 * u[:, 3:6]
    fx = 1.0 + 2.0 * (0.5 + 0.5 * u[:, 6])
    fy = 1.0 + 2.0 * (0.5 + 0.5 * u[:, 7])
    ph = np.pi * u[:, 8]
    cx, cy = 0.5 + 0.3 * u[:, 9], 0.5 + 0.3 * u[:, 10]
    rad = 0.15 + 0.1 * (0.5 + 0.5 * u[:, 11])
    lin = linspace(1.0, size, w.device)   # XLA's float32 linspace
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    grid = 2 * np.pi * (fx[:, None, None] * xs + fy[:, None, None] * ys) + ph[:, None, None]
    m = 0.5 + 0.5 * torch.sin(grid)
    blob = torch.exp(-(((xs - cx[:, None, None]) ** 2 + (ys - cy[:, None, None]) ** 2)
                       / (2 * rad[:, None, None] ** 2)))
    m = torch.clamp(m + blob, 0.0, 1.0)
    return c1[:, None, None, :] * m[..., None] + c2[:, None, None, :] * (1 - m[..., None])


def _render(params: dict, config: sg.StyleGAN2Config, w: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return sg.synthesis(params, sg.w_to_wplus(w, config), None, config, dtype=dtype)


def _device_of(params: dict) -> torch.device:
    return params["const"].device


@torch.no_grad()
def palette_identity_spread(params: dict, config: sg.StyleGAN2Config, n: int = 16, seed: int = 7) -> float:
    """Mean pairwise distance between the mean colours of n rendered random
    latents (a diagnostic: a random G already scores high)."""
    z = keys.normal(keys.PRNGKey(seed), (n, config.style_dim), device=_device_of(params))
    mean_col = _render(params, config, sg.mapping(params, z, config)).mean(dim=(1, 2))
    d = torch.linalg.vector_norm(mean_col[:, None] - mean_col[None], dim=-1)
    return float(d.sum() / (n * (n - 1)))


@torch.no_grad()
def palette_target_alignment(params: dict, config: sg.StyleGAN2Config, n: int = 32, seed: int = 7) -> float:
    """Correlation between the rendered and the procedural targets' mean
    colours over n random latents (~0 for a random G, -> 1 as it learns)."""
    dev = _device_of(params)
    P = target_basis(config.style_dim, device=dev)
    z = keys.normal(keys.PRNGKey(seed), (n, config.style_dim), device=dev)
    w = sg.mapping(params, z, config)
    got = _render(params, config, w).mean(dim=(1, 2)).double().cpu().numpy().ravel()
    want = procedural_targets(w, P, config.resolution).mean(dim=(1, 2)).double().cpu().numpy().ravel()
    got, want = got - got.mean(), want - want.mean()
    return float(np.dot(got, want) / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-12))


def _clone(tree, device):
    if isinstance(tree, dict):
        return {k: _clone(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def train_calibration_g(config: sg.StyleGAN2Config, n_steps: int = 2000, batch_size: int = 16, lr: float = 2e-3,
                        lambda_adv: float = 0.05, r1_gamma: float = 1.0, seed: int = 0, chunk: int = 25,
                        progress: bool = True, device=None, params: dict | None = None, d_params: dict | None = None,
                        dtype=torch.bfloat16):
    """Train synthesis (mapping frozen) to render the procedural targets.
    ``params`` (the port's parameter dict) and ``d_params`` (the JAX
    package's discriminator tree) give the initial weights; otherwise both
    are drawn from `seed`.  With ``lambda_adv == 0`` no discriminator is
    built.  Synthesis runs in `dtype` (bf16, as in the JAX package).
    Returns (params, D or None, losses {"mse", "d_loss", "g_adv"}, one
    value a step)."""
    device = resolve_device(device)
    P = target_basis(config.style_dim, device=device)
    if params is None:
        params = sg.init_generator(config, torch.Generator().manual_seed(seed), device)
    params = _clone(params, device)   # on `device`; the caller's weights stay as they were
    synth = {k: v for k, v in params.items() if k not in ("mapping", "w_avg")}
    g_leaves = _leaves(synth)
    for t in g_leaves:
        t.requires_grad_(True)
    D = d_opt = None
    if lambda_adv:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + 1)
            D = Discriminator(resolution=config.resolution, channel_multiplier=1)
        if d_params is not None:
            D.load_flax(d_params)
        D = D.to(device)
        d_opt = torch.optim.Adam(D.parameters(), lr=lr, betas=(0.0, 0.99))
    d_leaves = [] if D is None else list(D.parameters())
    g_opt = torch.optim.Adam(g_leaves, lr=lr, betas=(0.0, 0.99))
    base_key = keys.PRNGKey(seed + 2)

    def step(opt, loss, leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()

    mses, dls, advs = [], [], []
    zero = torch.zeros((), device=device)
    for it in range(n_steps):
        key = keys.fold_in(base_key, it)
        z = keys.normal(key, (batch_size, config.style_dim), device=device)
        with torch.no_grad():
            w = sg.mapping(params, z, config)   # frozen mapping
        if D is not None:
            zr = keys.normal(keys.fold_in(key, 1), (batch_size, config.style_dim), device=device)
            with torch.no_grad():
                fake = _render(params, config, w, dtype)
                real = procedural_targets(sg.mapping(params, zr, config), P, config.resolution)
            real.requires_grad_(bool(r1_gamma))
            d_real = D(real)
            d_loss = F.relu(1.0 - d_real).mean() + F.relu(1.0 + D(fake)).mean()
            if r1_gamma:
                g_img, = torch.autograd.grad(d_real.sum(), real, create_graph=True)
                d_loss = d_loss + 0.5 * r1_gamma * g_img.square().sum(dim=(1, 2, 3)).mean()
            step(d_opt, d_loss, d_leaves)
        else:
            d_loss = zero
        img = _render(params, config, w, dtype)
        mse = (img - procedural_targets(w, P, config.resolution)).square().mean()
        adv = -D(img).mean() if D is not None else zero
        step(g_opt, mse + lambda_adv * adv, g_leaves)
        mses.append(mse.detach())
        dls.append(d_loss.detach())
        advs.append(adv.detach())
        if progress and ((it + 1) % chunk == 0 or it + 1 == n_steps):
            print(f"step {it + 1}: mse {float(mse):.4f} d {float(d_loss):.4f} adv {float(adv):.4f}", flush=True)
    for t in g_leaves:
        t.requires_grad_(False)
    losses = {"mse": torch.stack(mses).tolist(), "d_loss": torch.stack(dls).tolist(),
              "g_adv": torch.stack(advs).tolist()}
    return params, D, losses
