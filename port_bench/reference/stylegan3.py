"""Plain StyleGAN3-T synthesis in float32, and the per-layer schedule.

Written from the published network (Karras et al. 2021, "Alias-Free
Generative Adversarial Networks", arXiv:2106.12423; NVlabs/stylegan3
``training/networks_stylegan3.py`` and ``torch_utils/ops/filtered_lrelu.py``
``_filtered_lrelu_ref``) and not from the port.  Each modulated convolution
modulates and demodulates its kernel per sample (a grouped convolution with
one group a frame).  Each filtered leaky ReLU inserts zeros to upsample,
pads, runs its 1-D filters over the whole grid (two depthwise convolutions),
applies bias-free leaky ReLU with its gain and clamp, filters again and
drops samples, exactly as ``_filtered_lrelu_ref`` with ``upfirdn2d``'s
reference does.  Its filters come from its own ``scipy.signal.firwin`` call.
Nothing here imports the port; TF32 is off in ``synthesis``.

Departures from the source:
- No mapping network runs: the benchmark's latents are W+ rows already
  (``mapping`` is here for the tests).
- Half precision is never used (the source runs the ``use_fp16`` layers in
  float16 on a CUDA device); ``quant`` (the control's) rounds the two
  operands of each convolution of those layers instead.
- The user transform of the Fourier input is the identity (the source's
  ``transform`` buffer at its initial value).
- Only the translation-equivariant configuration (``-t``): no radial
  filters, no 1 x 1 convolutions.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import tf32

DEFAULTS = {"resolution": 1024, "w_dim": 512, "num_layers": 14, "num_critical": 2, "first_cutoff": 2.0,
            "first_stopband": 2 ** 2.1, "last_stopband_rel": 2 ** 0.3, "margin_size": 10, "output_scale": 0.25,
            "channel_base": 32768, "channel_max": 512, "conv_kernel": 3, "filter_size": 6, "lrelu_upsampling": 2,
            "conv_clamp": 256.0, "num_fp16_res": 4, "img_channels": 3}


def schedule(g: dict) -> tuple[dict, list[dict]]:
    """The Fourier input's and each of the ``num_layers + 1`` layers' settings,
    as ``SynthesisNetwork.__init__`` and ``SynthesisLayer.__init__`` derive
    them from the configuration `g` (keys of ``DEFAULTS``)."""
    c = {**DEFAULTS, **g}
    n, res = c["num_layers"], c["resolution"]
    last_cutoff = res / 2
    last_stopband = last_cutoff * c["last_stopband_rel"]
    exponents = np.minimum(np.arange(n + 1) / (n - c["num_critical"]), 1)
    cutoffs = c["first_cutoff"] * (last_cutoff / c["first_cutoff"]) ** exponents
    stopbands = c["first_stopband"] * (last_stopband / c["first_stopband"]) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + c["margin_size"] * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((c["channel_base"] / 2) / cutoffs, c["channel_max"]))
    channels[-1] = c["img_channels"]
    inp = {"channels": int(channels[0]), "size": int(sizes[0]), "sampling_rate": float(rates[0]),
           "bandwidth": float(cutoffs[0])}
    layers = []
    for i in range(n + 1):
        p = max(i - 1, 0)
        torgb = i == n
        k = 1 if torgb else c["conv_kernel"]
        tmp = max(rates[p], rates[i]) * (1 if torgb else c["lrelu_upsampling"])
        up, down = int(np.rint(tmp / rates[p])), int(np.rint(tmp / rates[i]))
        up_taps = c["filter_size"] * up if up > 1 and not torgb else 1
        down_taps = c["filter_size"] * down if down > 1 and not torgb else 1
        pad_total = (sizes[i] - 1) * down + 1 - (sizes[p] + k - 1) * up + up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        pad_hi = pad_total - pad_lo
        layers.append({
            "index": i, "is_torgb": torgb, "use_fp16": bool(rates[i] * 2 ** c["num_fp16_res"] > res),
            "in_channels": int(channels[p]), "out_channels": int(channels[i]),
            "in_size": int(sizes[p]), "out_size": int(sizes[i]), "conv_kernel": k,
            "in_sampling_rate": float(rates[p]), "out_sampling_rate": float(rates[i]), "tmp_sampling_rate": float(tmp),
            "in_cutoff": float(cutoffs[p]), "out_cutoff": float(cutoffs[i]),
            "in_half_width": float(half_widths[p]), "out_half_width": float(half_widths[i]),
            "up": up, "down": down, "up_taps": up_taps, "down_taps": down_taps,
            "padding": (int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)),
            "gain": 1.0 if torgb else math.sqrt(2), "slope": 1.0 if torgb else 0.2, "clamp": c["conv_clamp"]})
    return inp, layers


def lowpass(numtaps: int, cutoff: float, width: float, fs: float, device=None) -> torch.Tensor | None:
    """``design_lowpass_filter``'s separable Kaiser filter, float32; None for one tap."""
    if numtaps == 1:
        return None
    import scipy.signal

    f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
    return torch.as_tensor(f, dtype=torch.float32, device=device)


def filters(layer: dict, device=None) -> tuple:
    """(up-filter, down-filter) of one layer."""
    fu = lowpass(layer["up_taps"], layer["in_cutoff"], layer["in_half_width"] * 2, layer["tmp_sampling_rate"], device)
    fd = lowpass(layer["down_taps"], layer["out_cutoff"], layer["out_half_width"] * 2, layer["tmp_sampling_rate"],
                 device)
    return fu, fd


def upfirdn2d(x: torch.Tensor, f: torch.Tensor | None, up: int = 1, down: int = 1, padding=(0, 0, 0, 0),
              gain: float = 1.0) -> torch.Tensor:
    """``_upfirdn2d_ref`` with a separable (1-D) filter or None: zeros
    inserted, pad or crop, the flipped filter over each axis in turn, every
    `down`-th sample kept."""
    B, C, H, W = x.shape
    px0, px1, py0, py1 = padding
    x = x.reshape(B, C, H, 1, W, 1)
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(B, C, H * up, W * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0), max(-px0, 0):x.shape[3] - max(-px1, 0)]
    if f is None:
        x = x * gain
    else:
        f = (f * gain ** 0.5).flip(0)
        x = F.conv2d(x, f[None, None, None, :].repeat(C, 1, 1, 1), groups=C)
        x = F.conv2d(x, f[None, None, :, None].repeat(C, 1, 1, 1), groups=C)
    return x[:, :, ::down, ::down]


def filtered_lrelu(x: torch.Tensor, fu, fd, b, up: int, down: int, padding, gain: float, slope: float,
                   clamp: float | None) -> torch.Tensor:
    """``_filtered_lrelu_ref``: bias, upsample (gain up²), leaky ReLU with
    its gain and clamp, then filter and downsample."""
    x = x + b.reshape(1, -1, 1, 1)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = torch.where(x >= 0, x, x * slope) * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return upfirdn2d(x, fd, down=down)


def fc(p: dict, x: torch.Tensor, lr_mul: float = 1.0) -> torch.Tensor:
    """``FullyConnectedLayer`` without activation."""
    w = p["weight"]
    return x @ (w * (lr_mul / math.sqrt(w.shape[1]))).T + p["bias"] * lr_mul


def mapping(p: dict, z: torch.Tensor, num_ws: int, lr_mul: float = 0.01, truncation_psi: float = 1.0) -> torch.Tensor:
    """z (B, 512) -> W+ (B, num_ws, 512): normalise, two lrelu layers, broadcast, truncation towards w_avg."""
    x = z * (z.square().mean(1, keepdim=True) + 1e-8).rsqrt()
    for layer in p["mapping"]:
        x = fc(layer, x, lr_mul)
        x = torch.where(x >= 0, x, 0.2 * x) * math.sqrt(2)
    x = x[:, None].repeat(1, num_ws, 1)
    return p["w_avg"].lerp(x, truncation_psi) if truncation_psi != 1 else x


def synthesis_input(p: dict, w: torch.Tensor, spec: dict) -> torch.Tensor:
    """``SynthesisInput.forward``: Fourier features turned and shifted by an affine of w, mixed by a C x C weight."""
    B, dev = w.shape[0], w.device
    freqs, phases = p["freqs"][None], p["phases"][None]
    t = fc(p["affine"], w)
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    m_r = torch.eye(3, device=dev)[None].repeat(B, 1, 1)
    m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
    m_t = torch.eye(3, device=dev)[None].repeat(B, 1, 1)
    m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
    transforms = m_r @ m_t
    phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
    freqs = freqs @ transforms[:, :2, :2]
    bw, sr, size = spec["bandwidth"], spec["sampling_rate"], spec["size"]
    amplitudes = (1 - (freqs.norm(dim=2) - bw) / (sr / 2 - bw)).clamp(0, 1)
    theta = torch.eye(2, 3, device=dev)
    theta[0, 0] = theta[1, 1] = 0.5 * size / sr
    grids = F.affine_grid(theta[None], [1, 1, size, size], align_corners=False)
    x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
    x = torch.sin((x + phases[:, None, None]) * (np.pi * 2)) * amplitudes[:, None, None]
    x = x @ (p["weight"] / math.sqrt(spec["channels"])).t()
    return x.permute(0, 3, 1, 2)


def modulated_conv2d(x, w, s, demodulate: bool, padding: int, input_gain, quant=None) -> torch.Tensor:
    """``modulated_conv2d``: kernel pre-normalised, modulated, demodulated and
    scaled by the input gain per sample; one grouped convolution."""
    B = x.shape[0]
    cout, cin, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w[None] * s[:, None, :, None, None]
    if demodulate:
        w = w * (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()[:, :, None, None, None]
    w = w * input_gain
    if quant is not None:
        x, w = quant(x), quant(w)
    out = F.conv2d(x.reshape(1, -1, *x.shape[2:]), w.reshape(-1, cin, kh, kw), padding=padding, groups=B)
    return out.reshape(B, -1, *out.shape[2:])


def synthesis_layer(p: dict, spec: dict, x: torch.Tensor, w: torch.Tensor, fu, fd, quant=None) -> torch.Tensor:
    """``SynthesisLayer.forward`` (no magnitude update)."""
    styles = fc(p["affine"], w)
    if spec["is_torgb"]:
        styles = styles * (1 / math.sqrt(spec["in_channels"] * spec["conv_kernel"] ** 2))
    x = modulated_conv2d(x, p["weight"], styles, demodulate=not spec["is_torgb"], padding=spec["conv_kernel"] - 1,
                         input_gain=p["magnitude_ema"].rsqrt(), quant=quant if spec["use_fp16"] else None)
    return filtered_lrelu(x, fu, fd, p["bias"], spec["up"], spec["down"], spec["padding"], spec["gain"],
                          spec["slope"], spec["clamp"])


def synthesis(p: dict, ws: torch.Tensor, g: dict, quant=None, control: bool = False) -> torch.Tensor:
    """W+ latents (B, num_layers + 2, 512) -> images (B, 3, R, R) float32, in
    about [-1, 1], unclamped.  TF32 off; with `control`, TF32 on in the
    float32 layers and `quant` on the operands of the half-precision
    layers' convolutions."""
    inp, layers = schedule(g)
    out_scale = {**DEFAULTS, **g}["output_scale"]
    with tf32(control):
        x = synthesis_input(p["input"], ws[:, 0], inp)
        for spec, lp, w in zip(layers, p["layers"], ws[:, 1:].unbind(1)):
            fu, fd = filters(spec, ws.device)
            with tf32(control and not spec["use_fp16"]):
                x = synthesis_layer(lp, spec, x, w, fu, fd, quant)
    return x * out_scale


def magnitudes(p: dict, ws: torch.Tensor, g: dict, block: int = 4) -> list[float]:
    """Each layer's input mean of x² over the frames of `ws`, as training's
    running average holds it: the layers set one after another (each layer's
    ``magnitude_ema`` in `p` is written before the next is measured), the
    frames `block` at a time; float32, TF32 off."""
    inp, layers = schedule(g)
    out = []
    with tf32(False), torch.no_grad():
        xs = [synthesis_input(p["input"], ws[i:i + block, 0], inp) for i in range(0, ws.shape[0], block)]
        for j, (spec, lp) in enumerate(zip(layers, p["layers"])):
            m = sum(float(x.square().sum()) for x in xs) / sum(x.numel() for x in xs)
            lp["magnitude_ema"] = torch.tensor(m, dtype=torch.float32, device=ws.device)
            out.append(m)
            if j + 1 < len(layers):
                fu, fd = filters(spec, ws.device)
                # kept contiguous: a downsampled output is a strided view of the whole filtered grid
                xs = [synthesis_layer(lp, spec, x, ws[i * block:(i + 1) * block, j + 1], fu, fd).contiguous()
                      for i, x in enumerate(xs)]
    return out
