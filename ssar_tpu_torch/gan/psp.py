"""pixel2style2pixel (pSp): image -> W+ inversion with an IR-SE trunk.

Counterpart of ``ssar_tpu/gan/psp.py``: an ArcFace-style IR-SE ResNet whose
three scale taps feed an FPN and per-style "map2style" heads
(``GradualStyleEncoder``), the two single-tap variants
(``BackboneEncoderW`` / ``BackboneEncoderWPlus``), and the pSp wrapper that
adds the decoder's average latent, mixes styles and runs the port's
StyleGAN2 synthesis as the decoder.

The encoders are channels-first modules with the upstream pSp encoder's
module names (``input_layer``, ``body.{i}.res_layer`` /
``shortcut_layer``, ``styles.{j}.convs`` / ``linear``, ``latlayer1/2``,
``output_layer_2``, ``linear``): an upstream checkpoint's ``encoder.*`` keys
load as they are (``convert_psp``), and ``BackboneEncoderWPlus`` flattens
(C, 7, 7) as torch does.  BatchNorm uses its frozen statistics; the
encoders run in full float32 (the JAX trunk pins ``Precision.HIGHEST``).
The public functions take and return channels-last images (B, H, W, 3), as
the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.resnet import FrozenBatchNorm
from ..utils.device import full_precision, resolve_device

# per-stage (in_channel, depth, num_units); the first unit of each stage has stride 2
IR_STAGES = {
    50: ((64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)),
    100: ((64, 64, 3), (64, 128, 13), (128, 256, 30), (256, 512, 3)),
    152: ((64, 64, 3), (64, 128, 8), (128, 256, 36), (256, 512, 3)),
}


def _stages(stages):
    return IR_STAGES[stages] if isinstance(stages, int) else stages


def stage_units(stages) -> list[tuple[int, int, int]]:
    """Stage specs (or a depth of ``IR_STAGES``) -> per-unit (in_c, depth, stride)."""
    units = []
    for in_c, depth, n in _stages(stages):
        units.append((in_c, depth, 2))
        units += [(depth, depth, 1)] * (n - 1)
    return units


# -------------------------------------------------------------- modules --
class EqualLinear(nn.Module):
    """rosinality's EqualLinear with lr_mul 1: the weight (out, in) scaled by
    1 / sqrt(in) at run time."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return F.linear(x, self.weight / float(np.sqrt(x.shape[-1])), self.bias)


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, max(1, channels // reduction), 1, bias=False)
        self.fc2 = nn.Conv2d(max(1, channels // reduction), channels, 1, bias=False)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))))
        return x * s


class BottleneckIR(nn.Module):
    """bottleneck_IR(_SE): BN, 3x3, PReLU, 3x3 carrying the stride, BN (,
    SE), plus the shortcut: a 1x1 conv + BN where the depth changes, else a
    strided slice (MaxPool2d(1, stride))."""

    def __init__(self, in_c: int, depth: int, stride: int, se: bool = True):
        super().__init__()
        self.stride = stride
        if in_c != depth:
            self.shortcut_layer = nn.Sequential(nn.Conv2d(in_c, depth, 1, stride, bias=False), FrozenBatchNorm(depth))
        layers = [FrozenBatchNorm(in_c), nn.Conv2d(in_c, depth, 3, 1, 1, bias=False), nn.PReLU(depth),
                  nn.Conv2d(depth, depth, 3, stride, 1, bias=False), FrozenBatchNorm(depth)]
        if se:
            layers.append(SEModule(depth))
        self.res_layer = nn.Sequential(*layers)

    def forward(self, x):
        sc = self.shortcut_layer(x) if hasattr(self, "shortcut_layer") else x[:, :, :: self.stride, :: self.stride]
        return self.res_layer(x) + sc


class GradualStyleBlock(nn.Module):
    """Stride-2 3x3 convs with LeakyReLU(0.01) down to 1x1, then EqualLinear."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        layers = []
        for i in range(max(1, int(np.log2(spatial)))):
            layers += [nn.Conv2d(in_c if i == 0 else out_c, out_c, 3, 2, 1), nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*layers)
        self.linear = EqualLinear(out_c, out_c)

    def forward(self, x):
        return self.linear(self.convs(x).flatten(1))


class _IRBackbone(nn.Module):
    """The shared stem and IR(-SE) body; ``taps`` returns the output of the
    last unit of each stage."""

    def __init__(self, stages, se: bool):
        super().__init__()
        units = stage_units(stages)
        stem = units[0][0]
        self.input_layer = nn.Sequential(nn.Conv2d(3, stem, 3, 1, 1, bias=False), FrozenBatchNorm(stem),
                                         nn.PReLU(stem))
        self.body = nn.Sequential(*[BottleneckIR(i, d, s, se) for i, d, s in units])
        self.ends = {int(e) for e in np.cumsum([n for _, _, n in _stages(stages)]) - 1}
        self.depths = [d for _, d, _ in _stages(stages)]

    def taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.input_layer(x)
        out = []
        for i, unit in enumerate(self.body):
            x = unit(x)
            if i in self.ends:
                out.append(x)
        return out


class GradualStyleEncoder(_IRBackbone):
    """(B, 3, H, W) -> (B, n_styles, style_dim): the three scale taps (ends
    of stages 2-4) through an FPN (bilinear, align_corners) into the coarse
    (3), middle (4) and fine style heads.  `input_res` sizes the heads'
    conv stacks (taps at input_res / 16, / 8, / 4)."""

    def __init__(self, stages=50, n_styles: int = 18, style_dim: int = 512, input_res: int = 256, se: bool = True):
        super().__init__(stages, se)
        c1d, c2d, c3d = self.depths[1:]
        self.styles = nn.ModuleList([
            GradualStyleBlock(c3d, style_dim, input_res // 16 if j < 3 else input_res // 8 if j < 7 else input_res // 4)
            for j in range(n_styles)])
        self.latlayer1 = nn.Conv2d(c2d, c3d, 1)
        self.latlayer2 = nn.Conv2d(c1d, c3d, 1)

    def forward(self, x):
        _, c1, c2, c3 = self.taps(x)
        n = len(self.styles)
        lat = [self.styles[j](c3) for j in range(min(3, n))]
        p2 = F.interpolate(c3, size=c2.shape[2:], mode="bilinear", align_corners=True) + self.latlayer1(c2)
        lat += [self.styles[j](p2) for j in range(3, min(7, n))]
        p1 = F.interpolate(p2, size=c1.shape[2:], mode="bilinear", align_corners=True) + self.latlayer2(c1)
        lat += [self.styles[j](p1) for j in range(7, n)]
        return torch.stack(lat, dim=1)


class BackboneEncoderW(_IRBackbone):
    """(B, 3, H, W) -> (B, style_dim): the last tap pooled, then EqualLinear."""

    def __init__(self, stages=50, style_dim: int = 512, se: bool = True):
        super().__init__(stages, se)
        self.linear = EqualLinear(self.depths[-1], style_dim)

    def forward(self, x):
        return self.linear(self.taps(x)[-1].mean(dim=(2, 3)))


class BackboneEncoderWPlus(_IRBackbone):
    """(B, 3, H, W) -> (B, n_styles, style_dim): the last tap through BN,
    a 7x7 adaptive average pool, a linear on the (C, 7, 7) flatten and an
    EqualLinear to every style."""

    def __init__(self, stages=50, n_styles: int = 18, style_dim: int = 512, se: bool = True):
        super().__init__(stages, se)
        c3d = self.depths[-1]
        self.output_layer_2 = nn.Sequential(FrozenBatchNorm(c3d), nn.AdaptiveAvgPool2d((7, 7)), nn.Flatten(),
                                            nn.Linear(c3d * 49, style_dim))
        self.linear = EqualLinear(style_dim, style_dim * n_styles)
        self.style_dim = style_dim

    def forward(self, x):
        h = self.linear(self.output_layer_2(self.taps(x)[-1]))
        return h.reshape(h.shape[0], -1, self.style_dim)


ENCODERS = {
    "GradualStyleEncoder": GradualStyleEncoder,
    "BackboneEncoderUsingLastLayerIntoW": BackboneEncoderW,
    "BackboneEncoderUsingLastLayerIntoWPlus": BackboneEncoderWPlus,
}


# ------------------------------------------------------------ functions --
def encode(encoder: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) on the encoder's device -> its codes, in full float32."""
    with full_precision():
        return encoder(images.permute(0, 3, 1, 2))


def gradual_style_encoder(encoder: GradualStyleEncoder, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_styles, style_dim) W+ codes."""
    return encode(encoder, images)


def backbone_encoder_w(encoder: BackboneEncoderW, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, style_dim)."""
    return encode(encoder, images)


def backbone_encoder_wplus(encoder: BackboneEncoderWPlus, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_styles, style_dim)."""
    return encode(encoder, images)


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out, out, C) with ``AdaptiveAvgPool2d``'s bins:
    bin i spans [floor(i n / out), ceil((i + 1) n / out))."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)


def psp_apply(psp: dict, images: torch.Tensor, config, *, input_code: bool = False, latent_mask=None,
              inject_latent: torch.Tensor | None = None, alpha: float | None = None, resize: bool = True,
              noises=None, dtype=torch.float32):
    """The pSp forward: encode (B, H, W, 3) images in [-1, 1] (or take them as
    codes with ``input_code``), add ``latent_avg``, broadcast a single W over
    the W+ rows, mix the rows of ``latent_mask`` (with ``inject_latent``,
    weighted by ``alpha`` when given; zeros without it), synthesise with the
    port's StyleGAN2 (``config`` the decoder's ``StyleGAN2Config``) and pool
    frames larger than 256 px to 256.  Returns (frames (B, R, R, 3), codes).

    `psp` is ``convert_psp``'s dict: {"encoder": module, "decoder": the
    port's StyleGAN2 parameters, "latent_avg": tensor or None}."""
    from .stylegan2 import synthesis

    if input_code:
        codes = images
    else:
        codes = encode(psp["encoder"], images)
        avg = psp.get("latent_avg")
        if avg is not None:
            avg = torch.as_tensor(avg, device=codes.device)
            codes = codes + (avg[None] if codes.ndim == avg.ndim + 1 else avg[None, None])
    if codes.ndim == 2:  # a single-W encoder: broadcast over the W+ rows
        codes = codes[:, None].expand(-1, config.n_latent, -1)

    if latent_mask is not None:
        codes = codes.clone()
        for i in latent_mask:
            if inject_latent is not None:
                mix = inject_latent[:, i] if alpha is None else alpha * inject_latent[:, i] + (1 - alpha) * codes[:, i]
            else:
                mix = torch.zeros_like(codes[:, i])
            codes[:, i] = mix

    frames = synthesis(psp["decoder"], codes, noises, config, dtype=dtype)
    if resize and frames.shape[1] > 256:
        frames = adaptive_avg_pool(frames, 256)
    return frames, codes


def invert_frames(psp: dict, frames, *, batch_size: int = 16, device: str | torch.device | None = None) -> torch.Tensor:
    """Video frames (T, H, W, 3) in [-1, 1] -> the W+ trajectory
    (T, n_styles, style_dim) on `device` (the card unless ``"cpu"``): the
    StyleVideoGAN front end.  The encoder moves to the device once; the
    frames go over in chunks of `batch_size` (the last one shorter: a
    frame's code does not depend on its batch)."""
    device = resolve_device(device)
    encoder = psp["encoder"].to(device).eval()
    frames = torch.as_tensor(frames if torch.is_tensor(frames) else np.asarray(frames), dtype=torch.float32)
    with torch.no_grad():
        w = torch.cat([encode(encoder, frames[s : s + batch_size].to(device))
                       for s in range(0, frames.shape[0], batch_size)])
    avg = psp.get("latent_avg")
    if avg is not None:
        w = w + torch.as_tensor(avg, device=device)[None]
    return w


# ----------------------------------------------------------------- init --
def init_random_tree(seed: int = 0, stages=50, n_styles: int = 18, input_res: int = 256, style_dim: int = 512,
                     se: bool = True, encoder_type: str = "GradualStyleEncoder", dtype=np.float32) -> dict:
    """The JAX package's random encoder tree (its layout, HWIO kernels, drawn
    from ``RandomState(seed)`` in its order), as numpy."""
    rng = np.random.RandomState(seed)

    def conv(ci, co, k):
        return (rng.randn(k, k, ci, co) * (2.0 / (k * k * ci)) ** 0.5).astype(dtype)

    def bn(c):
        return {"scale": np.ones(c, dtype), "bias": np.zeros(c, dtype),
                "mean": np.zeros(c, dtype), "var": np.ones(c, dtype)}

    units = stage_units(stages)
    stem = units[0][0]
    params: dict = {"input": {"conv": conv(3, stem, 3), "bn": bn(stem), "prelu": np.full(stem, 0.25, dtype)}}
    body = []
    for in_c, depth, _ in units:
        u = {"bn_in": bn(in_c), "conv1": conv(in_c, depth, 3), "prelu": np.full(depth, 0.25, dtype),
             "conv2": conv(depth, depth, 3), "bn_out": bn(depth)}
        if se:
            u["se"] = {"fc1": conv(depth, max(1, depth // 16), 1), "fc2": conv(max(1, depth // 16), depth, 1)}
        if in_c != depth:
            u["shortcut"] = {"conv": conv(in_c, depth, 1), "bn": bn(depth)}
        body.append(u)
    params["body"] = body

    c1d, c2d, c3d = [d for _, d, _ in _stages(stages)][1:]
    if encoder_type == "GradualStyleEncoder":
        styles = []
        for j in range(n_styles):
            sp = input_res // 16 if j < 3 else input_res // 8 if j < 7 else input_res // 4
            convs = [{"kernel": conv(c3d if i == 0 else style_dim, style_dim, 3), "bias": np.zeros(style_dim, dtype)}
                     for i in range(max(1, int(np.log2(sp))))]
            styles.append({"convs": convs, "linear": {"weight": rng.randn(style_dim, style_dim).astype(dtype),
                                                      "bias": np.zeros(style_dim, dtype)}})
        params["styles"] = styles
        params["lat1"] = {"kernel": conv(c2d, c3d, 1), "bias": np.zeros(c3d, dtype)}
        params["lat2"] = {"kernel": conv(c1d, c3d, 1), "bias": np.zeros(c3d, dtype)}
    elif encoder_type == "BackboneEncoderUsingLastLayerIntoW":
        params["linear"] = {"weight": rng.randn(c3d, style_dim).astype(dtype), "bias": np.zeros(style_dim, dtype)}
    else:  # IntoWPlus
        params["out_bn"] = bn(c3d)
        params["out_linear"] = {"weight": rng.randn(49 * c3d, style_dim).astype(dtype) / np.sqrt(49 * c3d),
                                "bias": np.zeros(style_dim, dtype)}
        params["linear"] = {"weight": rng.randn(style_dim, style_dim * n_styles).astype(dtype),
                            "bias": np.zeros(style_dim * n_styles, dtype)}
    return params


def make_encoder(encoder_type: str = "GradualStyleEncoder", stages=50, n_styles: int = 18, style_dim: int = 512,
                 input_res: int = 256, se: bool = True) -> nn.Module:
    """An encoder module of `encoder_type` (a key of ``ENCODERS``)."""
    if encoder_type == "GradualStyleEncoder":
        return GradualStyleEncoder(stages, n_styles, style_dim, input_res, se)
    if encoder_type == "BackboneEncoderUsingLastLayerIntoW":
        return BackboneEncoderW(stages, style_dim, se)
    if encoder_type == "BackboneEncoderUsingLastLayerIntoWPlus":
        return BackboneEncoderWPlus(stages, n_styles, style_dim, se)
    raise ValueError(f"encoder_type must be one of {list(ENCODERS)}, got {encoder_type!r}")


def init_random_params(seed: int = 0, stages=50, n_styles: int = 18, input_res: int = 256, style_dim: int = 512,
                       se: bool = True, encoder_type: str = "GradualStyleEncoder") -> nn.Module:
    """A random encoder with the JAX package's weights (``init_random_tree``),
    on the CPU."""
    from ..models.convert_extractors import from_flax_psp

    encoder = make_encoder(encoder_type, stages, n_styles, style_dim, input_res, se)
    encoder.load_state_dict(from_flax_psp(init_random_tree(seed, stages, n_styles, input_res, style_dim, se,
                                                           encoder_type)))
    return encoder.eval()


# ------------------------------------------------------------ converter --
def convert_psp(state_dict: dict, stages=50, decoder_config=None, device=None) -> dict:
    """An upstream pSp checkpoint's state_dict (``encoder.*``, ``decoder.*``,
    ``latent_avg``) -> {"encoder": module, "latent_avg": tensor or None,
    "decoder": the port's StyleGAN2 parameters, when ``decoder_config`` is
    given, through ``gan.convert``'s rosinality loader}.  The encoder's type,
    style count and width, SE units and head depth are read from the keys
    and shapes; it is loaded strictly, on `device` (the CPU by default)."""
    enc = {k[len("encoder."):]: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
           for k, v in state_dict.items() if k.startswith("encoder.")}
    se = "body.0.res_layer.5.fc1.weight" in enc
    if "styles.0.linear.weight" in enc:
        n_styles = 1 + max(int(k.split(".")[1]) for k in enc if k.startswith("styles."))
        n_convs = sum(1 for k in enc if k.startswith("styles.0.convs.") and k.endswith(".weight"))
        encoder = GradualStyleEncoder(stages, n_styles, enc["styles.0.linear.weight"].shape[0],
                                      16 * 2**n_convs, se)
    elif "output_layer_2.3.weight" in enc:
        style_dim = enc["output_layer_2.3.weight"].shape[0]
        encoder = BackboneEncoderWPlus(stages, enc["linear.weight"].shape[0] // style_dim, style_dim, se)
    else:
        encoder = BackboneEncoderW(stages, enc["linear.weight"].shape[0], se)
    encoder.load_state_dict(enc)
    out = {"encoder": encoder.eval().to(device),
           "latent_avg": (torch.as_tensor(np.asarray(state_dict["latent_avg"]), dtype=torch.float32, device=device)
                          if "latent_avg" in state_dict else None)}
    dec = {k[len("decoder."):]: v for k, v in state_dict.items() if k.startswith("decoder.")}
    if dec and decoder_config is not None:
        from .convert import convert_rosinality_sd

        out["decoder"] = convert_rosinality_sd(dec, decoder_config, device=device)
    return out
