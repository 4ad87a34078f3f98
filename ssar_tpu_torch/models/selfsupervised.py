"""The self-supervised model family: StyleVideoGAN, the LSTM reactor and the
patch-contrastive loss.

Counterpart of ``ssar_tpu/models/selfsupervised.py``:
- ``StyleVideoGenerator`` / ``StyleVideoDiscriminator``: a latent-trajectory
  GAN over W+ sequences;
- ``ZoneoutLSTMCell`` (LayerNorm on the gates; zoneout draws one mask a step
  from the module's generator through ``keys.bernoulli``), ``Hidden2Style``,
  ``LSTMReactor`` (its carry starts from the music embedding m);
- ``sample_patches_1d`` (starts from ``keys.randint``), ``PatchContrastor``
  (InfoNCE both ways);
- ``sslstm_features`` and ``sslstm_inference`` on the port's features and
  render loop.
Parameter names follow the flax modules (``load_flax``, ``flax_tree``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..generate import keys
from ._flax import Conv, FlaxModule, leaky_relu
from .backbones import MultiLayerRNN


# --------------------------------------------------------- StyleVideoGAN --
class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x**2).mean(dim=-1, keepdim=True) + 1e-8)


class StyleVideoGenerator(FlaxModule):
    """Seed trajectory s (B, L, latent_dim) -> W+ (B, L, n_styles, 512): an MLP
    maps the first frame to the 4 GRU layers' initial states, the GRUs roll
    the trajectory, a shared trunk and per-style heads emit W+ rows."""

    def __init__(self, n_styles: int = 18, latent_dim: int = 32):
        super().__init__()
        D = self.latent_dim = latent_dim
        self.n_styles = n_styles
        widths = (64, 64, 96, 96)
        self.init_mlp = nn.ModuleList(nn.Linear(a, b) for a, b in zip((D,) + widths[:-1], widths))
        self.gru = MultiLayerRNN(D, 4, "gru")
        self.traj_norm = nn.LayerNorm(D, eps=1e-6)
        self.pixel_norm = PixelNorm()
        trunk = (64, 128, 256, 512)
        self.trunk = nn.ModuleList(nn.Linear(a, b) for a, b in zip((D,) + trunk[:-1], trunk))
        self.trunk_norm = nn.LayerNorm(512, eps=1e-6)
        self.heads = nn.ModuleList(nn.Linear(512, 512) for _ in range(n_styles))
        self.head_norms = nn.ModuleList(nn.LayerNorm(512, eps=1e-6) for _ in range(n_styles))

    def flax_children(self):
        out = {f"Dense_{i}": m for i, m in enumerate(self.init_mlp)}
        out.update({f"Dense_{4 + i}": m for i, m in enumerate(self.trunk)})
        out.update({f"Dense_{8 + i}": m for i, m in enumerate(self.heads)})
        out.update({"LayerNorm_1": self.traj_norm, "LayerNorm_2": self.trunk_norm})
        out.update({f"LayerNorm_{3 + i}": m for i, m in enumerate(self.head_norms)})
        out["*GRUCell"] = self.gru   # flax's GRUCell_0..3 sit beside the Dense layers
        return out

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        B, L, D = s.shape
        i = s[:, 0]
        h = i
        for lin in self.init_mlp:
            h = leaky_relu(lin(h))
        h = F.layer_norm(h, h.shape[-1:], eps=1e-6)
        parts = list(h.chunk(3, dim=-1)) + [i]
        h0 = [p[:, :D] if p.shape[-1] >= D else F.pad(p, (0, D - p.shape[-1])) for p in parts]
        traj = torch.cat([i[:, None], self.gru(s[:, 1:], initial_states=h0)], dim=1)   # (B, L, D)
        t = self.pixel_norm(self.traj_norm(traj.reshape(B * L, D)))
        for lin in self.trunk:
            t = leaky_relu(lin(t))
        t = self.trunk_norm(t)
        styles = [norm(leaky_relu(lin(t))) for lin, norm in zip(self.heads, self.head_norms)]
        return torch.stack(styles, dim=1).reshape(B, L, self.n_styles, 512)


class StyleVideoDiscriminator(FlaxModule):
    """(B, L, n_styles, 512) -> (B,) realness in (-1, 1)."""

    def __init__(self, seq_len: int = 24, n_styles: int = 18, latent_dim: int = 32):
        super().__init__()
        widths = (n_styles * 256, n_styles * 128, n_styles * 64, n_styles * 32, n_styles * 16, latent_dim)
        self.embed = nn.ModuleList(nn.Linear(a, b) for a, b in zip((n_styles * 512,) + widths[:-1], widths))
        self.conv1 = Conv(latent_dim, 64, 5, stride=2)
        self.conv2 = Conv(64, 128, 5, stride=2)
        t = -(-(-(-seq_len // 2)) // 2)   # two SAME stride-2 convs
        self.out = nn.Linear(t * 128, 1)
        self.n_styles, self.latent_dim = n_styles, latent_dim

    def flax_children(self):
        out = {f"Dense_{i}": m for i, m in enumerate(self.embed)}
        out.update({"Conv_0": self.conv1, "Conv_1": self.conv2, "Dense_6": self.out})
        return out

    def forward(self, lw: torch.Tensor) -> torch.Tensor:
        B, L = lw.shape[:2]
        e = lw.reshape(B * L, self.n_styles * 512)
        for lin in self.embed:
            e = leaky_relu(lin(e))
        h = e.reshape(B, L, self.latent_dim)
        h = leaky_relu(self.conv2(leaky_relu(self.conv1(h))))
        return torch.tanh(self.out(h.reshape(B, -1)))[:, 0]


# ------------------------------------------------------------ LSTMReactor --
class ZoneoutLSTMCell(FlaxModule):
    """LayerNorm LSTM cell with zoneout: carry (h, c)."""

    def __init__(self, in_features: int, features: int, zoneout: float = 0.0):
        super().__init__()
        self.gates = nn.Linear(in_features + features, 4 * features)
        self.norm = nn.LayerNorm(4 * features, eps=1e-6)
        self.zoneout = zoneout

    def flax_children(self):
        return {"Dense_0": self.gates, "LayerNorm_0": self.norm}

    def forward(self, carry, x: torch.Tensor, generator: torch.Generator | None = None):
        h, c = carry
        i, f, g, o = self.norm(self.gates(torch.cat([x, h], dim=-1))).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        if self.zoneout > 0 and self.training:
            mask = keys.bernoulli(generator, self.zoneout, new_h.shape, new_h.device)
            new_h = torch.where(mask, h, new_h)
            new_c = torch.where(mask, c, new_c)
        return (new_h, new_c), new_h


class Hidden2Style(FlaxModule):
    """Hidden states -> per-style W+ rows: Dense(512)(leaky(Dense(512)(h)))."""

    def __init__(self, in_features: int, n_styles: int = 18):
        super().__init__()
        self.inner = nn.ModuleList(nn.Linear(in_features, 512) for _ in range(n_styles))
        self.outer = nn.ModuleList(nn.Linear(512, 512) for _ in range(n_styles))

    def flax_children(self):
        # flax builds the outer Dense before evaluating its argument: outer 2k, inner 2k + 1
        out = {f"Dense_{2 * k}": m for k, m in enumerate(self.outer)}
        out.update({f"Dense_{2 * k + 1}": m for k, m in enumerate(self.inner)})
        return out

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.stack([o(leaky_relu(i(h))) for i, o in zip(self.inner, self.outer)], dim=2)


class LSTMReactor(FlaxModule):
    """(B, T, F) features + music embedding m (B, D) -> (W+ (B, T, n_styles,
    512), per-layer outputs (layers, B, T, H), per-layer final cell states
    (layers, B, H))."""

    def __init__(self, in_features: int, hidden_size: int = 32, num_layers: int = 4, n_styles: int = 18,
                 zoneout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.cells = nn.ModuleList(ZoneoutLSTMCell(in_features if i == 0 else hidden_size, hidden_size, zoneout)
                                   for i in range(num_layers))
        self.to_style = Hidden2Style(hidden_size, n_styles)

    def flax_children(self):
        return {**{f"ZoneoutLSTMCell_{i}": c for i, c in enumerate(self.cells)}, "Hidden2Style_0": self.to_style}

    def forward(self, x: torch.Tensor, m: torch.Tensor, generator: torch.Generator | None = None):
        B, H = x.shape[0], self.hidden_size
        inter_l, inter_c = [], []
        l = x
        for cell in self.cells:
            m_state = m[:, :H].expand(B, H)
            carry, ys = (m_state, m_state), []
            for t in range(l.shape[1]):
                carry, y = cell(carry, l[:, t], generator)
                ys.append(y)
            l = torch.stack(ys, dim=1)
            inter_l.append(l)
            inter_c.append(carry[1])
        return self.to_style(l), torch.stack(inter_l), torch.stack(inter_c)


# ------------------------------------------------------ patch contrastive --
def sample_patches_1d(key, seq: torch.Tensor, n_patches: int, patch_len: int) -> torch.Tensor:
    """(B, T, D) -> (B * n_patches, patch_len * D) random temporal crops."""
    B, T, D = seq.shape
    starts = keys.randint(key, 0, T - patch_len + 1, shape=(B, n_patches), device=seq.device)
    idx = starts[..., None] + torch.arange(patch_len, device=seq.device)
    patches = torch.gather(seq[:, None].expand(B, n_patches, T, D), 2, idx[..., None].expand(-1, -1, -1, D))
    return patches.reshape(B * n_patches, patch_len * D)


class PatchContrastor(FlaxModule):
    """PatchNCE between two patch sets: both MLP-projected and normalised,
    matching rows positive, InfoNCE with temperature tau both ways."""

    def __init__(self, in_a: int, in_b: int, embed_dim: int = 128, tau: float = 0.07):
        super().__init__()
        self.a1, self.a2 = nn.Linear(in_a, 256), nn.Linear(256, embed_dim)
        self.b1, self.b2 = nn.Linear(in_b, 256), nn.Linear(256, embed_dim)
        self.tau = tau

    def flax_children(self):
        return {"a_1": self.a1, "a_2": self.a2, "b_1": self.b1, "b_2": self.b2}

    @staticmethod
    def _proj(x, first, second):
        h = second(leaky_relu(first(x)))
        return h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-8)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        za, zb = self._proj(a, self.a1, self.a2), self._proj(b, self.b1, self.b2)
        logits = za @ zb.T / self.tau
        labels = torch.arange(za.shape[0], device=za.device)
        return (F.cross_entropy(logits, labels, reduction="none")
                + F.cross_entropy(logits.T, labels, reduction="none")).mean() / 2


# ----------------------------------------------------------- inference --
def sslstm_features(audio, sr: int, device=None) -> torch.Tensor:
    """The contrastive LSTM's input: norm-normalised mfcc(19) + chroma CENS
    (12) + onset strength (1) = (T, 32), on `device` (the CUDA device unless
    given)."""
    from ..audio import features as AF
    from ..audio.beat import onset_strength
    from ..utils.device import resolve_device

    audio = torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))
    m = AF.mfcc(audio, sr, n_mfcc=19)
    c = AF.chromagram(audio, sr)
    o = onset_strength(AF.percussive(audio), sr)[:, None]
    T = min(m.shape[0], c.shape[0], o.shape[0])
    feats = [m[:T], c[:T], o[:T]]
    return torch.cat([f / (torch.linalg.vector_norm(f) + 1e-12) for f in feats], dim=1)


@torch.no_grad()
def sslstm_inference(reactor: LSTMReactor, audio, sr: int, gan_params=None, gan_config=None,
                     out_file: str | None = None, fps: int = 24, batch_size: int = 8, output_size=(256, 256),
                     seed: int = 0, device=None):
    """A trained LSTMReactor -> W+ sequence [-> rendered video].  The motion
    seed is ``keys.normal`` of ``seed``.  Returns (w_seq, out_file)."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    feats = sslstm_features(audio, int(sr), device)[None]
    motion_seed = keys.normal(keys.PRNGKey(seed), (1, reactor.hidden_size), device=device)
    was_training = reactor.training
    w_seq = reactor.eval()(feats, motion_seed)[0][0]
    reactor.train(was_training)
    if out_file is not None and gan_params is not None:
        from ..gan import stylegan2 as sg
        from ..gan.render import render_latents_to_video
        from ..gan.wrapper import StyleGAN2Synthesizer

        config = gan_config or sg.StyleGAN2Config()
        syn = StyleGAN2Synthesizer(config=config, params=gan_params, device=device)
        n_lat = config.n_latent
        w = w_seq[:, :n_lat] if w_seq.shape[1] >= n_lat else torch.cat(
            [w_seq, w_seq[:, -1:].expand(-1, n_lat - w_seq.shape[1], -1)], dim=1)
        render_latents_to_video(syn, w, None, out_file, fps=fps, batch_size=batch_size, output_size=output_size,
                                progress=False)
    return w_seq, out_file
