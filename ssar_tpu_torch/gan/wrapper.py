"""StyleGAN2 mapper / synthesizer wrappers: the maua-style call surface.

Counterpart of ``ssar_tpu/gan/wrapper.py``:

- ``StyleGAN2Mapper(model_file)``: z -> W+, and ``mean_latent``;
- ``StyleGAN2Synthesizer(model_file, output_size, strategy, layer)``: W+
  latents plus noise (``noises=[...]`` NHWC, or ``noise0..noiseN`` NCHW
  keywords) -> frames, with network bends (``set_bends``);
- ``StyleGAN2``: both on one set of weights, ``get_w_latents`` and the
  streaming ``render``;
- ``make_noise_pyramid``: a base noise video resized to every layer's size;
- ``StyleGAN3Synthesizer``: the same call for StyleGAN3-T
  (``stylegan3.py``), which takes no noise and no bends;
  ``synthesizer_for`` builds the synthesizer of a configuration's family.

``model_file`` is a rosinality ``.pt``, an NVIDIA ``.pkl``, an ``.npz`` of
the JAX package's layout, or ``None`` (random weights from ``seed``).  Every
class runs on the CUDA device unless ``device`` says otherwise.  Seeded
draws of z come from ``torch.Generator`` and differ from ``jax.random``'s;
they go through ``latent_draw``, which a caller (or a test) may replace.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize
from ..utils.device import resolve_device
from . import stylegan2 as sg
from . import stylegan3 as sg3
from .convert import load_npz, load_nvidia_pkl, load_rosinality_pt
from .render import _pad_batch


def load_params(model_file: str | None, config: sg.StyleGAN2Config, seed: int = 0, device=None) -> dict:
    if model_file is None:
        return sg.init_generator(config, torch.Generator().manual_seed(seed), device=device)
    name = str(model_file)
    if name.endswith(".pt"):
        return load_rosinality_pt(name, config, device=device)
    if name.endswith(".npz"):
        return load_npz(name, device=device)
    if name.endswith(".pkl"):
        return load_nvidia_pkl(name, config, device=device)
    raise ValueError(f"unsupported checkpoint format: {model_file}")


def latent_draw(n: int, style_dim: int, seed: int) -> torch.Tensor:
    """(n, style_dim) standard-normal z from a generator seeded with `seed`."""
    return torch.randn(n, style_dim, generator=torch.Generator().manual_seed(int(seed)))


class StyleGAN2Mapper:
    """z (B, 512) -> W+ (B, n_latent, 512)."""

    def __init__(self, model_file: str | None = None, inference: bool = False,
                 config: sg.StyleGAN2Config | None = None, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.config = config or sg.StyleGAN2Config()
        self.params = load_params(model_file, self.config, seed, self.device)

    @torch.no_grad()
    def __call__(self, z) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)
        return sg.w_to_wplus(sg.mapping(self.params, z, self.config), self.config)

    def mean_latent(self, n_samples: int = 4096, seed: int = 0) -> torch.Tensor:
        """Monte-Carlo mean W+ latent (1, n_latent, 512): the truncation anchor."""
        return self(latent_draw(n_samples, self.config.style_dim, seed)).mean(dim=0, keepdim=True)


class StyleGAN2Synthesizer:
    """W+ latents + noise -> frames (B, H, W, 3) in [-1, 1] (unclamped).

    ``output_size`` (W, H) may be any size: the network stops early at
    ``min(native, the next power of two >= max(output_size, 4))`` and the
    frames are resized bilinearly (``ops.resize``, ``jax.image.resize``'s
    semantics) to (H, W) where that differs.  ``strategy``, ``layer`` and
    ``inference`` are taken for the reference's call surface and not used
    (the reference's one behaviour is its "stretch").
    """

    def __init__(self, model_file: str | None = None, inference: bool = False,
                 output_size: tuple[int, int] | None = None, strategy: str = "stretch", layer: int = 0,
                 config: sg.StyleGAN2Config | None = None, seed: int = 0, dtype=torch.bfloat16,
                 device: str | torch.device | None = None, params: dict | None = None):
        self.device = resolve_device(device)
        self.config = config or sg.StyleGAN2Config()
        self.params = params if params is not None else load_params(model_file, self.config, seed, self.device)
        self.dtype = dtype
        self.output_size = None if output_size is None else (int(output_size[0]), int(output_size[1]))
        native = self.config.resolution
        if output_size is None:
            self.synth_res = native
        else:
            self.synth_res = min(native, 1 << int(np.ceil(np.log2(max(max(self.output_size), 4)))))
        self.bends: dict = {}
        self.bend_mods: dict = {}  # level -> whole-track (T, ...) modulation
        # weight-derived constants, computed once per checkpoint
        self.prep = sg.prepare_synthesis(self.params, self.config, self.dtype)

    def set_bends(self, bends) -> None:
        """Install network bends: a {level: transform} dict, or the
        reference's list of {"layer": int, "transform": callable[,
        "modulation": (T, ...) array]}.  Transforms take the level's NCHW
        activations (see ``stylegan2.synthesis``); one with a "modulation" is
        called as ``transform(x, modulation[frame_idx])`` for each batch.  A
        modulation may be a numpy array or a tensor on any device, one that
        requires grad included (it is detached)."""
        mods = {}
        if isinstance(bends, (list, tuple)):
            for b in bends:
                m = b.get("modulation")
                if m is not None:
                    m = m.detach() if isinstance(m, torch.Tensor) else m
                    mods[int(b["layer"])] = torch.as_tensor(m, dtype=torch.float32, device=self.device)
            bends = {int(b["layer"]): b["transform"] for b in bends}
        self.bends = dict(bends or {})
        self.bend_mods = mods

    @property
    def n_noises_used(self) -> int:
        """Number of noise layers consumed at the synthesis resolution."""
        return (int(np.log2(self.synth_res)) - 2) * 2 + 1

    @torch.no_grad()
    def __call__(self, latents, noises: list | None = None, frame_idx=None, **noise_kwargs) -> torch.Tensor:
        """latents (B, n_ws, 512); noise as ``noises``, a list of (B, H, W, 1)
        (None entries mean no noise at that layer), or as ``noise0``,
        ``noise1``, ... keywords of (B, 1, H, W).  `frame_idx` (B,) are the
        batch's frame numbers, needed only by animated bends (clipped to the
        modulation's length; 0 .. B - 1 when omitted)."""
        latents = torch.as_tensor(latents, dtype=torch.float32).to(self.device)
        if noises is None and noise_kwargs:
            order = sorted(int(k.removeprefix("noise")) for k in noise_kwargs)
            noises = [torch.as_tensor(noise_kwargs[f"noise{i}"]).permute(0, 2, 3, 1) for i in order]
        if noises is not None:
            n_used = self.n_noises_used
            noises = [None if n is None else torch.as_tensor(n).to(self.device, self.dtype)
                      for n in list(noises)[:n_used]]
            noises += [None] * (self.config.num_layers - len(noises))
        mods = {}
        if self.bend_mods:
            fi = torch.arange(latents.shape[0]) if frame_idx is None else torch.as_tensor(frame_idx)
            fi = fi.to(self.device)
            mods = {lvl: m[fi.clamp(0, m.shape[0] - 1)] for lvl, m in self.bend_mods.items()}
        img = sg.synthesis(self.params, latents, noises, self.config, dtype=self.dtype,
                           output_size=self.synth_res, prep=self.prep, bends=self.bends, bend_mods=mods)
        if self.output_size is not None and tuple(img.shape[1:3]) != self.output_size[::-1]:
            w, h = self.output_size
            img = resize(img, (img.shape[0], h, w, 3))
        return img


class StyleGAN2:
    """Mapper and synthesizer on one set of weights."""

    def __init__(self, model_file: str | None = None, inference: bool = False,
                 output_size: tuple[int, int] | None = None, strategy: str = "stretch", layer: int = 0,
                 config: sg.StyleGAN2Config | None = None, seed: int = 0, dtype=torch.bfloat16,
                 device: str | torch.device | None = None):
        self.config = config or sg.StyleGAN2Config()
        self.mapper = StyleGAN2Mapper(model_file, inference, config=self.config, seed=seed, device=device)
        self.synthesizer = StyleGAN2Synthesizer(output_size=output_size, strategy=strategy, layer=layer,
                                                config=self.config, dtype=dtype, device=self.mapper.device,
                                                params=self.mapper.params)

    def get_w_latents(self, seeds) -> torch.Tensor:
        """W+ latents (len(seeds), n_latent, 512), one z drawn per seed; `seeds`
        is a list or a comma-separated string."""
        if isinstance(seeds, str):
            seeds = [int(s) for s in seeds.split(",")]
        return self.mapper(torch.cat([latent_draw(1, self.config.style_dim, s) for s in seeds]))

    def render(self, inputs: dict, batch_size: int = 8, postprocess_fn=None):
        """Stream frames of ``inputs["latents"]`` (T, n_ws, 512) with the
        optional ``inputs["noise"]``, a list of (T, 1, H, W): yields (H, W, 3)
        float32 numpy frames in [0, 1], clipped before `postprocess_fn`."""
        latents = torch.as_tensor(inputs["latents"], dtype=torch.float32)
        noise_seq = inputs.get("noise")
        T = latents.shape[0]

        def synth(i):
            ns = None
            if noise_seq is not None:
                ns = [_pad_batch(torch.as_tensor(n[i : i + batch_size]), batch_size).permute(0, 2, 3, 1)
                      for n in noise_seq]
            frames = self.synthesizer(_pad_batch(latents[i : i + batch_size], batch_size), noises=ns)
            frames = torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0)
            return postprocess_fn(frames) if postprocess_fn is not None else frames

        starts = list(range(0, T, batch_size))
        pending = synth(starts[0]) if starts else None
        for j, i in enumerate(starts):
            nxt = synth(starts[j + 1]) if j + 1 < len(starts) else None  # queued before batch j is fetched
            yield from pending.cpu().numpy()[: min(batch_size, T - i)]
            pending = nxt


def make_noise_pyramid(noise, layers: int | None = None, config: sg.StyleGAN2Config | None = None) -> list:
    """(T, 1, H, W) base noise -> the per-layer (T, 1, h, w) noises: resized
    bilinearly to each layer's size and divided by their standard deviation."""
    config = config or sg.StyleGAN2Config()
    noise = torch.as_tensor(noise, dtype=torch.float32)
    shapes = config.noise_shapes()[:layers] if layers is not None else config.noise_shapes()
    out = []
    for h, w in shapes:
        n = resize(noise, (noise.shape[0], noise.shape[1], h, w))
        out.append(n / (n.std(unbiased=False) + 1e-8))
    return out


class StyleGAN3Synthesizer:
    """W+ latents (B, n_latent, 512) -> frames (B, H, W, 3) in [-1, 1]
    (unclamped) through StyleGAN3-T's synthesis, with ``StyleGAN2Synthesizer``'s
    call.  The network has no noise inputs (``n_noises_used`` is 0; noise
    passed in raises) and takes no bends.  It always synthesises at its
    native resolution; another ``output_size`` (W, H) is a bilinear resize.
    `dtype` is the precision of the layers the network marks half precision
    (float16 as published on the card; float32 on the CPU, as the source).
    """

    def __init__(self, model_file: str | None = None, inference: bool = False,
                 output_size: tuple[int, int] | None = None, strategy: str = "stretch", layer: int = 0,
                 config: sg3.StyleGAN3Config | None = None, seed: int = 0, dtype=None,
                 device: str | torch.device | None = None, params: dict | None = None):
        self.device = resolve_device(device)
        self.config = config or sg3.StyleGAN3Config()
        if params is None and model_file is not None:
            raise NotImplementedError(f"StyleGAN3 checkpoints do not load yet ({model_file}): pass params or None")
        self.params = params if params is not None else sg3.init_generator(
            self.config, torch.Generator().manual_seed(seed), device=self.device)
        self.dtype = dtype or (torch.float16 if self.device.type == "cuda" else torch.float32)
        self.output_size = None if output_size is None else (int(output_size[0]), int(output_size[1]))
        self.bend_mods: dict = {}
        self.prep = sg3.prepare_synthesis(self.params, self.config, self.dtype, self.device)

    n_noises_used = 0

    def set_bends(self, bends) -> None:
        if bends:
            raise ValueError("StyleGAN3Synthesizer takes no network bends")

    @torch.no_grad()
    def __call__(self, latents, noises: list | None = None, frame_idx=None, **noise_kwargs) -> torch.Tensor:
        if noise_kwargs or any(n is not None for n in (noises or [])):
            raise ValueError("StyleGAN3 has no noise inputs")
        latents = torch.as_tensor(latents, dtype=torch.float32).to(self.device)
        img = sg3.synthesis(self.params, latents, self.config, self.prep).permute(0, 2, 3, 1)
        if self.output_size is not None and tuple(img.shape[1:3]) != self.output_size[::-1]:
            w, h = self.output_size
            img = resize(img, (img.shape[0], h, w, 3))
        return img


def synthesizer_for(config, **kw):
    """The synthesizer of `config`'s family: ``StyleGAN3Synthesizer`` for a
    ``StyleGAN3Config``, else ``StyleGAN2Synthesizer``."""
    cls = StyleGAN3Synthesizer if isinstance(config, sg3.StyleGAN3Config) else StyleGAN2Synthesizer
    return cls(config=config, **kw)
