"""The other model families' trainers: Audio2Latent, PSAGAN, StyleVideoGAN, SS-LSTM.

Counterpart of ``ssar_tpu/train/trainers.py``: each is a plain loop of
``torch.optim.Adam`` steps with optax's hyperparameters (b1 = 0, b2 = 0.99
for the PSAGAN pair), on the CUDA device unless ``device="cpu"``.  The random
draws (the GANs' noise, the patch starts, the frames of the video-patch loss)
thread ``generate/keys.py`` keys as the JAX trainers thread ``jax.random``
keys, so a test injects JAX's draws; dropout masks come from a generator on
the device.  Initial weights come from a CPU generator seeded with `seed`,
or from flax trees (``params`` / ``g_params`` / ``d_params``).  Losses are
read back once, after the loop.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..generate import keys
from ..utils.device import resolve_device
from .data import compute_stats


def _build(make, seed: int, tree, device):
    """A module from `make()` with weights drawn after ``manual_seed(seed)``
    (the caller's random state left as it was), or copied from a flax tree."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = make()
    if tree is not None:
        module.load_flax(tree.get("params", tree))
    return module.to(device).train()


def _step(opt, loss: torch.Tensor, params: list) -> None:
    """One optimizer step on the gradients of `loss` with respect to `params`
    alone (a GAN's other network gets none)."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    opt.step()


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


# ------------------------------------------------------------- a2l (v1) --
def train_audio2latent(dataset, n_steps: int = 200, lr: float = 1e-4, batch_size: int = 8,
                       backbone: str = "gru", hidden_size: int = 32, num_layers: int = 2, seed: int = 0,
                       eval_fcd: bool = False, device=None, params: dict | None = None):
    """Supervised W+ regression with the v1 model; with ``eval_fcd`` the
    Frechet Context Distance of 16 predicted windows against their latents.
    Returns (model, metrics)."""
    from ..models.audio2latent import Audio2Latent

    device = resolve_device(device)
    mean, std = compute_stats(dataset.features)
    model = _build(lambda: Audio2Latent(mean, std, hidden_size=hidden_size, num_layers=num_layers,
                                        backbone=backbone), seed, params, device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    dropout_gen = torch.Generator(device).manual_seed(seed)
    batches = dataset.batches(batch_size, seed=seed)
    losses = []
    for _ in range(n_steps):
        feats, lats, *_ = next(batches)
        pred = model(_tensor(feats, device), dropout_gen)
        loss = (pred - _tensor(lats, device)).square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).tolist()
    metrics = {"final_loss": losses[-1], "losses": losses}
    if eval_fcd:
        from ..metrics.context_fid import context_fid, train_encoder

        model.eval()
        T = dataset.latents.shape[1]
        real = np.asarray(dataset.latents[:16]).reshape(16, T, -1)[..., :64]
        with torch.no_grad():
            pred = model(_tensor(dataset.features[:16], device)).reshape(16, T, -1)[..., :64]
        enc = train_encoder(real, n_steps=50, device=device)
        metrics["fcd"] = context_fid(enc, real, pred)
        model.train()
    return model, metrics


# ------------------------------------------------------------------ GAN --
def train_psagan(dataset, n_steps: int = 100, lr: float = 2e-4, batch_size: int = 8, features: int = 32,
                 n_stages: int = 3, seed: int = 0, device=None, g_params: dict | None = None,
                 d_params: dict | None = None):
    """The progressive latent-sequence GAN: hinge losses, a D step then a G
    step per batch, conditioned on the audio features; W+ targets projected
    to 128 dimensions by a fixed random matrix.  Returns ((G, D), metrics)."""
    from ..models.psagan import ProgressiveDiscriminator, ProgressiveGenerator

    device = resolve_device(device)
    lat_dim = int(np.prod(dataset.latents.shape[2:]))
    cond_dim = dataset.features.shape[-1]
    proj = keys.normal(keys.PRNGKey(7), (lat_dim, 128), device=device) / np.sqrt(lat_dim)
    G = _build(lambda: ProgressiveGenerator(cond_dim, out_dim=128, features=features, n_stages=n_stages),
               seed, g_params, device)
    D = _build(lambda: ProgressiveDiscriminator(128, cond_dim, features=features, n_stages=n_stages),
               seed + 1, d_params, device)
    gp, dp = list(G.parameters()), list(D.parameters())
    g_opt = torch.optim.Adam(gp, lr=lr, betas=(0.0, 0.99))
    d_opt = torch.optim.Adam(dp, lr=lr, betas=(0.0, 0.99))
    batches = dataset.batches(batch_size, seed=seed)
    key = keys.PRNGKey(seed)
    d_losses, g_losses = [], []
    for _ in range(n_steps):
        feats, lats, *_ = next(batches)
        feats = _tensor(feats, device)
        real = _tensor(lats, device).reshape(*lats.shape[:2], -1) @ proj
        key, k1, k2 = keys.split(key, 3)
        with torch.no_grad():
            fake = G(feats, k1)
        d_loss = F.relu(1.0 - D(real, feats)).mean() + F.relu(1.0 + D(fake, feats)).mean()
        _step(d_opt, d_loss, dp)
        g_loss = -D(G(feats, k2), feats).mean()
        _step(g_opt, g_loss, gp)
        d_losses.append(d_loss.detach())
        g_losses.append(g_loss.detach())
    return (G, D), {"d_losses": torch.stack(d_losses).tolist(), "g_losses": torch.stack(g_losses).tolist()}


def train_stylevideogan(wplus_sequences, n_steps: int = 100, lr: float = 2e-4, batch_size: int = 4,
                        latent_dim: int = 32, seed: int = 0, device=None, g_params: dict | None = None,
                        d_params: dict | None = None):
    """The latent-trajectory GAN over W+ sequences (N, L, n_styles, 512):
    non-saturating logistic losses.  Returns ((G, D), metrics)."""
    from ..models.selfsupervised import StyleVideoDiscriminator, StyleVideoGenerator

    device = resolve_device(device)
    N, L, n_styles, _ = wplus_sequences.shape
    G = _build(lambda: StyleVideoGenerator(n_styles=n_styles, latent_dim=latent_dim), seed, g_params, device)
    D = _build(lambda: StyleVideoDiscriminator(seq_len=L, n_styles=n_styles, latent_dim=latent_dim),
               seed + 1, d_params, device)
    gp, dp = list(G.parameters()), list(D.parameters())
    g_opt, d_opt = torch.optim.Adam(gp, lr=lr), torch.optim.Adam(dp, lr=lr)
    data = _tensor(wplus_sequences, device)
    key = keys.PRNGKey(seed)
    rng = np.random.RandomState(seed)
    d_losses, g_losses = [], []
    for _ in range(n_steps):
        sel = torch.as_tensor(rng.randint(0, N, batch_size), device=device)
        key, k1, k2 = keys.split(key, 3)
        with torch.no_grad():
            fake = G(keys.normal(k1, (batch_size, L, latent_dim), device=device))
        d_loss = F.softplus(-D(data[sel])).mean() + F.softplus(D(fake)).mean()
        _step(d_opt, d_loss, dp)
        g_loss = F.softplus(-D(G(keys.normal(k2, (batch_size, L, latent_dim), device=device)))).mean()
        _step(g_opt, g_loss, gp)
        d_losses.append(d_loss.detach())
        g_losses.append(g_loss.detach())
    return (G, D), {"d_losses": torch.stack(d_losses).tolist(), "g_losses": torch.stack(g_losses).tolist()}


# ------------------------------------------------------ contrastive LSTM --
def _pooled_width(config, output_size: int = 32) -> int:
    """Channels of synthesis(return_features=True, output_size)'s levels."""
    chans = config.channels()
    return sum(chans[r] for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)
               if r <= min(output_size, config.resolution))


def train_sslstm(dataset, n_steps: int = 100, lr: float = 1e-4, batch_size: int = 4, hidden_size: int = 16,
                 num_layers: int = 2, n_patches: int = 8, patch_len: int = 8, seed: int = 0, gan_params=None,
                 gan_config=None, video_patch_weight: float = 0.0, device=None, params: dict | None = None):
    """The contrastive LSTM reactor: W+-sequence patches against audio-feature
    patches (PatchNCE).  With ``video_patch_weight > 0`` and a frozen
    generator (``gan_params``, the port's parameter dict, and ``gan_config``),
    the pooled synthesis activations (``return_features=True``, 32 px) of two
    random predicted frames per window are contrasted with the audio patches
    too.  ``params`` is a flax tree {"model", "contrastor"[,
    "video_contrastor"]}.  Returns ((model, contrastor, video_contrastor or
    None), metrics)."""
    from ..gan import stylegan2 as sg
    from ..models.selfsupervised import LSTMReactor, PatchContrastor, sample_patches_1d

    device = resolve_device(device)
    params = params or {}
    F_in = dataset.features.shape[-1]
    model = _build(lambda: LSTMReactor(F_in, hidden_size=hidden_size, num_layers=num_layers), seed,
                   params.get("model"), device)
    n_styles = 18
    contrastor = _build(lambda: PatchContrastor(patch_len * n_styles * 512, patch_len * F_in), seed + 1,
                        params.get("contrastor"), device)
    modules = [model, contrastor]
    video_contrastor = gcfg = prep = None
    if video_patch_weight > 0 and gan_params is not None:
        gcfg = gan_config or sg.StyleGAN2Config(resolution=64)
        video_contrastor = _build(lambda: PatchContrastor(2 * _pooled_width(gcfg), patch_len * F_in), seed + 2,
                                  params.get("video_contrastor"), device)
        modules.append(video_contrastor)
        prep = sg.prepare_synthesis(gan_params, gcfg)   # the frozen G's constants, once
    trained = [p for m in modules for p in m.parameters()]
    opt = torch.optim.Adam(trained, lr=lr)
    batches = dataset.batches(batch_size, seed=seed)
    key = keys.PRNGKey(seed)
    losses = []
    for _ in range(n_steps):
        feats = _tensor(next(batches)[0], device)
        key, sub = keys.split(key)
        B, T = feats.shape[:2]
        w = model(feats, torch.zeros(B, hidden_size, device=device))[0]
        k1, k2 = keys.split(sub)
        pa = sample_patches_1d(k1, w.reshape(B, T, -1), n_patches, patch_len)
        pb = sample_patches_1d(k1, feats, n_patches, patch_len)
        loss = contrastor(pa, pb)
        if video_contrastor is not None:
            frame_idx = keys.randint(k2, 0, w.shape[1], shape=(2,), device=device)
            wf = w[:, frame_idx].reshape(-1, w.shape[2], w.shape[3])
            _, gfeats = sg.synthesis(gan_params, wf, None, gcfg, prep=prep, return_features=True, output_size=32)
            pooled = torch.cat([f.float().mean(dim=(2, 3)) for f in gfeats], dim=-1).reshape(B, -1)
            pv = pooled.repeat_interleave(n_patches, dim=0)[: pb.shape[0]]
            loss = loss + video_patch_weight * video_contrastor(pv, pb)
        _step(opt, loss, trained)   # the frozen G gets no gradient
        losses.append(loss.detach())
    return (model, contrastor, video_contrastor), {"losses": torch.stack(losses).tolist()}
