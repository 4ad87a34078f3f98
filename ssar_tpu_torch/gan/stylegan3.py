"""StyleGAN3-T generator (alias-free, translation-equivariant), functional PyTorch.

The network of Karras et al. 2021 (arXiv:2106.12423; NVlabs/stylegan3
``training/networks_stylegan3.py``, configuration ``stylegan3-t``): a
two-layer mapping network, a Fourier-feature input turned and shifted by an
affine of the first W+ row, and ``num_layers`` synthesis layers plus ToRGB,
each a modulated convolution followed by a filtered leaky ReLU
(``ops/filtered_lrelu.py``).  Every layer's cutoff, stopband, sampling rate,
size and width follow from the configuration (``StyleGAN3Config.schedule``).

As in the StyleGAN2 port, a modulated convolution scales the input by the
style and the output by the demodulation, one dense convolution for the
batch: ``conv(x, W * s * d * g) = conv(x * s * g, W) * d``.  The weight's and
the style's pre-normalisation are the source's; the style's RMS is taken a
sample (the source takes it over the batch, a scale the demodulation
cancels).  Layers that the source marks ``use_fp16`` run in `half` (float16
on the card; pass None for float32 throughout), the others in float32 with
TF32 off.  ``prepare_synthesis`` designs the filters on the host and puts
them, the normalised kernels and the demodulation Grams on the device once.

Parameters are a plain dict in torch layout:
``{"mapping": [{"weight", "bias"}] * 2, "w_avg", "input": {"weight", "affine":
{"weight", "bias"}, "freqs", "phases"}, "layers": [{"affine": {"weight",
"bias"}, "weight", "bias", "magnitude_ema"}] * (num_layers + 1)}``.

Spans: ``synthesis.sg3.input`` around the Fourier input and
``synthesis.sg3.filter`` around each filtered leaky ReLU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.filtered_lrelu import FilteredLReLU, design_lowpass_filter
from ..utils.device import full_precision
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    is_torgb: bool
    use_fp16: bool
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    conv_kernel: int
    in_sampling_rate: float
    out_sampling_rate: float
    tmp_sampling_rate: float
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    up: int
    down: int
    up_taps: int
    down_taps: int
    padding: tuple          # (px0, px1, py0, py1) on the upsampled grid


@dataclasses.dataclass(frozen=True)
class StyleGAN3Config:
    """``stylegan3-t`` as published at 1024 px (``stylegan3-t-ffhqu-1024x1024.pkl``)."""
    resolution: int = 1024
    z_dim: int = 512
    w_dim: int = 512
    mapping_layers: int = 2
    lr_mlp: float = 0.01
    num_layers: int = 14            # synthesis layers, ToRGB not counted
    num_critical: int = 2
    first_cutoff: float = 2.0
    first_stopband: float = 2 ** 2.1
    last_stopband_rel: float = 2 ** 0.3
    margin_size: int = 10
    output_scale: float = 0.25
    channel_base: int = 32768
    channel_max: int = 512
    conv_kernel: int = 3
    filter_size: int = 6
    lrelu_upsampling: int = 2
    conv_clamp: float | None = 256.0
    num_fp16_res: int = 4
    img_channels: int = 3

    @property
    def style_dim(self) -> int:
        return self.w_dim

    @property
    def n_latent(self) -> int:
        """W+ rows: the input's, one a layer and ToRGB's (16 at the published depth)."""
        return self.num_layers + 2

    @functools.cached_property
    def _schedule(self):
        n, res = self.num_layers, self.resolution
        last_cutoff = res / 2
        exponents = np.minimum(np.arange(n + 1) / (n - self.num_critical), 1)
        cutoffs = self.first_cutoff * (last_cutoff / self.first_cutoff) ** exponents
        stopbands = self.first_stopband * (last_cutoff * self.last_stopband_rel / self.first_stopband) ** exponents
        rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
        half_widths = np.maximum(stopbands, rates / 2) - cutoffs
        sizes = rates + self.margin_size * 2
        sizes[-2:] = res
        channels = np.rint(np.minimum((self.channel_base / 2) / cutoffs, self.channel_max))
        channels[-1] = self.img_channels
        layers = []
        for i in range(n + 1):
            p = max(i - 1, 0)
            torgb = i == n
            k = 1 if torgb else self.conv_kernel
            tmp = max(rates[p], rates[i]) * (1 if torgb else self.lrelu_upsampling)
            up, down = int(np.rint(tmp / rates[p])), int(np.rint(tmp / rates[i]))
            up_taps = self.filter_size * up if up > 1 and not torgb else 1
            down_taps = self.filter_size * down if down > 1 and not torgb else 1
            total = (sizes[i] - 1) * down + 1 - (sizes[p] + k - 1) * up + up_taps + down_taps - 2
            lo = int((total + up) // 2)    # the symmetric interpretation of sample positions
            hi = int(total) - lo
            layers.append(LayerSpec(
                index=i, is_torgb=torgb, use_fp16=bool(rates[i] * 2 ** self.num_fp16_res > res),
                in_channels=int(channels[p]), out_channels=int(channels[i]), in_size=int(sizes[p]),
                out_size=int(sizes[i]), conv_kernel=k, in_sampling_rate=float(rates[p]),
                out_sampling_rate=float(rates[i]), tmp_sampling_rate=float(tmp), in_cutoff=float(cutoffs[p]),
                out_cutoff=float(cutoffs[i]), in_half_width=float(half_widths[p]),
                out_half_width=float(half_widths[i]), up=up, down=down, up_taps=up_taps, down_taps=down_taps,
                padding=(lo, hi, lo, hi)))
        inp = {"channels": int(channels[0]), "size": int(sizes[0]), "sampling_rate": float(rates[0]),
               "bandwidth": float(cutoffs[0])}
        return inp, tuple(layers)

    def input_spec(self) -> dict:
        """The Fourier input's channels, size, sampling rate and bandwidth."""
        return dict(self._schedule[0])

    def schedule(self) -> tuple[LayerSpec, ...]:
        """The ``num_layers + 1`` layers (ToRGB last)."""
        return self._schedule[1]

    def filters(self, spec: LayerSpec) -> tuple:
        """(up-filter, down-filter) of a layer, float64 numpy or None."""
        fu = design_lowpass_filter(spec.up_taps, spec.in_cutoff, spec.in_half_width * 2, spec.tmp_sampling_rate)
        fd = design_lowpass_filter(spec.down_taps, spec.out_cutoff, spec.out_half_width * 2, spec.tmp_sampling_rate)
        return fu, fd


# ------------------------------------------------------------------ init --
def init_generator(config: StyleGAN3Config, generator: torch.Generator | None = None, device=None) -> dict:
    """The source's initialisation, drawn from `generator` on the CPU:
    N(0, 1) weights (mapping weights over their learning-rate multiplier),
    style biases 1, the input's affine 0 with bias (1, 0, 0, 0), Fourier
    frequencies on a disc within the bandwidth, phases U(-0.5, 0.5), other
    biases 0, every ``magnitude_ema`` 1 and ``w_avg`` 0."""
    def randn(*shape):
        return torch.randn(shape, generator=generator)

    inp = config.input_spec()
    c = inp["channels"]
    freqs = randn(c, 2)
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    freqs = freqs / (radii * radii.square().exp().pow(0.25)) * inp["bandwidth"]
    phases = torch.rand((c,), generator=generator) - 0.5
    params = {
        "mapping": [{"weight": randn(config.w_dim, config.z_dim if i == 0 else config.w_dim) / config.lr_mlp,
                     "bias": torch.zeros(config.w_dim)} for i in range(config.mapping_layers)],
        "w_avg": torch.zeros(config.w_dim),
        "input": {"weight": randn(c, c), "affine": {"weight": torch.zeros(4, config.w_dim),
                                                     "bias": torch.tensor([1.0, 0.0, 0.0, 0.0])},
                  "freqs": freqs, "phases": phases},
        "layers": [{"affine": {"weight": randn(s.in_channels, config.w_dim), "bias": torch.ones(s.in_channels)},
                    "weight": randn(s.out_channels, s.in_channels, s.conv_kernel, s.conv_kernel),
                    "bias": torch.zeros(s.out_channels), "magnitude_ema": torch.ones(())}
                   for s in config.schedule()],
    }
    return _to(params, device)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device, torch.float32)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


# --------------------------------------------------------------- mapping --
def _fc(p: dict, x: torch.Tensor, lr_mul: float = 1.0) -> torch.Tensor:
    w = p["weight"]
    return x @ (w * (lr_mul / math.sqrt(w.shape[1]))).T + p["bias"] * lr_mul


def mapping(params: dict, z: torch.Tensor, config: StyleGAN3Config, truncation_psi: float = 1.0) -> torch.Tensor:
    """z (B, z_dim) -> W+ (B, n_latent, w_dim), truncated towards ``w_avg``."""
    x = z.float()
    x = x * (x.square().mean(1, keepdim=True) + 1e-8).rsqrt()
    for layer in params["mapping"]:
        x = F.leaky_relu(_fc(layer, x, config.lr_mlp), 0.2) * math.sqrt(2)
    x = x[:, None].expand(-1, config.n_latent, -1)
    return params["w_avg"].lerp(x, truncation_psi) if truncation_psi != 1 else x


# ------------------------------------------------------------- synthesis --
def prepare_synthesis(params: dict, config: StyleGAN3Config, half=torch.float16, device=None) -> dict:
    """Every weight-derived constant of the synthesis, computed once a set of
    weights: each layer's dtype, its kernel (pre-normalised where it
    demodulates) in that dtype, the float32 demodulation Gram
    ``w2[o, i] = sum_k W[o, i, k]**2``, the input gain
    ``magnitude_ema**-1/2`` and its filtered leaky ReLU with the designed
    filters on the device; the Fourier input's mixing weight."""
    device = params["input"]["weight"].device if device is None else device
    layers = []
    for spec, p in zip(config.schedule(), params["layers"]):
        dtype = half if (spec.use_fp16 and half is not None) else torch.float32
        w = p["weight"].float()
        if not spec.is_torgb:
            w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        fu, fd = config.filters(spec)
        layers.append({
            "dtype": dtype, "kernel": w.to(device, dtype).contiguous(),
            "w2": w.square().sum(dim=(2, 3)).to(device) if not spec.is_torgb else None,
            "input_gain": p["magnitude_ema"].float().rsqrt().to(device),
            "filter": FilteredLReLU(fu, fd, spec.up, spec.down, spec.padding,
                                    1.0 if spec.is_torgb else math.sqrt(2), 1.0 if spec.is_torgb else 0.2,
                                    config.conv_clamp, spec.out_channels, device, dtype)})
    c = config.input_spec()["channels"]
    return {"input_weight": (params["input"]["weight"].float() / math.sqrt(c)).to(device), "layers": layers}


def synthesis_input(params: dict, w: torch.Tensor, config: StyleGAN3Config, weight: torch.Tensor) -> torch.Tensor:
    """w (B, w_dim) -> the Fourier features (B, C, size, size), float32."""
    spec = config.input_spec()
    p = params["input"]
    t = _fc(p["affine"], w)
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    c, s, tx, ty = t.unbind(1)
    # the inverse rotation after the inverse translation, as 2 x 2 and a column
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)            # (B, 2, 2)
    shift = torch.stack([-c * tx + s * ty, -s * tx - c * ty], -1)[..., None]              # (B, 2, 1)
    freqs = p["freqs"][None] @ rot                                                          # (B, C, 2)
    phases = p["phases"][None] + (p["freqs"][None] @ shift).squeeze(2)                     # (B, C)
    bw, sr, size = spec["bandwidth"], spec["sampling_rate"], spec["size"]
    amplitudes = (1 - (freqs.norm(dim=2) - bw) / (sr / 2 - bw)).clamp(0, 1)
    grid = ((torch.arange(size, device=w.device, dtype=torch.float32) + 0.5) * (2.0 / size) - 1.0) * (0.5 * size / sr)
    x = grid[None, None, :, None] * freqs[:, None, None, :, 0] + grid[None, :, None, None] * freqs[:, None, None, :, 1]
    x = torch.sin((x + phases[:, None, None]) * (2 * np.pi)) * amplitudes[:, None, None]
    return (x @ weight.t()).permute(0, 3, 1, 2)


def synthesis_layer(p: dict, prep: dict, spec: LayerSpec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One layer: the modulated convolution in the layer's dtype, then its filtered leaky ReLU."""
    dtype = prep["dtype"]
    styles = _fc(p["affine"], w)
    if spec.is_torgb:
        styles = styles * (1 / math.sqrt(spec.in_channels * spec.conv_kernel ** 2))
    else:
        styles = styles * styles.square().mean(1, keepdim=True).rsqrt()
    scale = styles * prep["input_gain"]
    out = F.conv2d(x.to(dtype) * scale.to(dtype)[:, :, None, None], prep["kernel"], padding=spec.conv_kernel - 1)
    if not spec.is_torgb:
        demod = torch.rsqrt(styles.square() @ prep["w2"].T + 1e-8)
        out = out * demod.to(dtype)[:, :, None, None]
    with span("synthesis.sg3.filter"):   # F1 takes a contiguous input (the first layer's conv gives channels-last)
        return prep["filter"](out.contiguous(), p["bias"])


def synthesis(params: dict, latents: torch.Tensor, config: StyleGAN3Config, prep: dict) -> torch.Tensor:
    """W+ latents (B, n_latent, w_dim) -> images (B, 3, R, R) float32 in about
    [-1, 1], unclamped.  ``prep`` comes from ``prepare_synthesis``."""
    latents = latents.float()
    cuda = latents.device.type == "cuda"
    with span("synthesis.sg3.input"), (full_precision() if cuda else contextlib.nullcontext()):
        x = synthesis_input(params, latents[:, 0], config, prep["input_weight"])
    for spec, p, lp, w in zip(config.schedule(), params["layers"], prep["layers"], latents[:, 1:].unbind(1)):
        scope = full_precision() if cuda and lp["dtype"] == torch.float32 else contextlib.nullcontext()
        with scope:
            x = synthesis_layer(p, lp, spec, x, w)
    return x.float() * config.output_scale
