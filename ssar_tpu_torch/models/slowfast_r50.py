"""SlowFast R50 (Kinetics SLOWFAST_8x8_R50) and its per-layer feature extractor.

Counterpart of ``ssar_tpu/models/slowfast_r50.py``: a two-pathway 3-D
ResNet-50 (a Slow pathway over every alpha-th frame, a low-channel Fast
pathway over all frames) with Fast -> Slow lateral fusions after the stem
and stages 2-4, and the acav100m LayerSlowFast extractor that pools each
stage's pathways spatially, nearest-upsamples the slow stream to the fast
frame rate and concatenates channels: five (B, T, C) feature levels of dims
[88, 352, 704, 1408, 2304] for the 8x8 R50.

``SlowFastR50`` is channels-first (B, 3, T, H, W) with facebook-slowfast's
module names (``s1.pathway{p}_stem``, ``s{k}_fuse``,
``s{k}.pathway{p}_res{j}.branch{1,2}``), so its checkpoints load as they are
(``models.convert_extractors.load_slowfast_r50`` drops the classification
head).  BatchNorm uses its frozen statistics; convolutions run in full
float32, as the JAX model pins ``Precision.HIGHEST``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import full_precision, resolve_device
from .resnet import FrozenBatchNorm

KINETICS_MEAN = np.array([0.45, 0.45, 0.45], np.float32)
KINETICS_STD = np.array([0.225, 0.225, 0.225], np.float32)


@dataclass(frozen=True)
class SlowFastConfig:
    """SLOWFAST_8x8_R50 defaults (facebook-slowfast Kinetics/c2 yaml)."""

    alpha: int = 4                  # fast/slow frame-rate ratio
    beta_inv: int = 8               # slow/fast channel ratio
    width: int = 64                 # slow stem width
    depths: tuple = (3, 4, 6, 3)    # bottlenecks per stage (R50)
    fusion_kernel: int = 7          # FuseFastToSlow temporal kernel
    fusion_ratio: int = 2           # fuse output = fast_ch * ratio
    # temporal kernel of each stage's 1x1x1 "a" conv, per pathway
    temp_kernels_slow: tuple = (1, 1, 3, 3)
    temp_kernels_fast: tuple = (3, 3, 3, 3)
    spatial_strides: tuple = (1, 2, 2, 2)

    @property
    def fast_width(self) -> int:
        return self.width // self.beta_inv

    def stage_dims(self, pathway: int) -> list[tuple[int, int]]:
        """Per-stage (dim_inner, dim_out)."""
        base = self.width if pathway == 0 else self.fast_width
        return [(base * 2**i, base * 4 * 2**i) for i in range(len(self.depths))]

    def feature_dims(self) -> list[int]:
        """Channels of the five per-layer features ([88, 352, 704, 1408, 2304]
        for the 8x8 R50): slow (with the fused fast channels but after the
        last stage) + fast."""
        dims = [self.width + self.fast_width * (self.fusion_ratio + 1)]
        last = len(self.depths) - 1
        for i, ((_, s), (_, f)) in enumerate(zip(self.stage_dims(0), self.stage_dims(1))):
            dims.append(s + f * ((self.fusion_ratio if i < last else 0) + 1))
        return dims


def _conv3(cin: int, cout: int, kernel, stride=(1, 1, 1)) -> nn.Conv3d:
    kt, kh, kw = kernel
    return nn.Conv3d(cin, cout, kernel, stride, (kt // 2, kh // 2, kw // 2), bias=False)


class _Stem(nn.Module):
    def __init__(self, cout: int, kt: int):
        super().__init__()
        self.conv = nn.Conv3d(3, cout, (kt, 7, 7), (1, 2, 2), (kt // 2, 3, 3), bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        h = F.relu(self.bn(self.conv(x)))
        return F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class _Fuse(nn.Module):
    """FuseFastToSlow: a temporal conv of the fast stream down to the slow
    frame rate, concatenated onto the slow channels."""

    def __init__(self, cin: int, cout: int, kt: int, alpha: int):
        super().__init__()
        self.conv_f2s = nn.Conv3d(cin, cout, (kt, 1, 1), (alpha, 1, 1), (kt // 2, 0, 0), bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, slow, fast):
        return torch.cat([slow, F.relu(self.bn(self.conv_f2s(fast)))], dim=1)


class _Branch2(nn.Module):
    """BottleneckTransform: temporal 1x1 "a", spatial 3x3 "b" carrying the
    stride (STRIDE_1X1 = False), 1x1 "c"."""

    def __init__(self, cin: int, inner: int, cout: int, kt: int, stride: int):
        super().__init__()
        self.a = _conv3(cin, inner, (kt, 1, 1))
        self.a_bn = FrozenBatchNorm(inner)
        self.b = _conv3(inner, inner, (1, 3, 3), (1, stride, stride))
        self.b_bn = FrozenBatchNorm(inner)
        self.c = _conv3(inner, cout, (1, 1, 1))
        self.c_bn = FrozenBatchNorm(cout)

    def forward(self, x):
        h = F.relu(self.a_bn(self.a(x)))
        h = F.relu(self.b_bn(self.b(h)))
        return self.c_bn(self.c(h))


class _ResBlock(nn.Module):
    def __init__(self, cin: int, inner: int, cout: int, kt: int, stride: int, shortcut: bool):
        super().__init__()
        if shortcut:
            self.branch1 = _conv3(cin, cout, (1, 1, 1), (1, stride, stride))
            self.branch1_bn = FrozenBatchNorm(cout)
        self.branch2 = _Branch2(cin, inner, cout, kt, stride)

    def forward(self, x):
        sc = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return F.relu(self.branch2(x) + sc)


class SlowFastR50(nn.Module):
    """Slow (B, 3, T / alpha, H, W) + fast (B, 3, T, H, W), normalised ->
    the five per-stage feature maps' (B, T, C) pools."""

    def __init__(self, config: SlowFastConfig = SlowFastConfig()):
        super().__init__()
        cfg = self.config = config
        fast_w = cfg.fast_width
        s1 = nn.Module()
        s1.pathway0_stem = _Stem(cfg.width, 1)
        s1.pathway1_stem = _Stem(fast_w, 5)
        self.s1 = s1
        self.s1_fuse = _Fuse(fast_w, fast_w * cfg.fusion_ratio, cfg.fusion_kernel, cfg.alpha)
        s_in, f_in = cfg.width + fast_w * cfg.fusion_ratio, fast_w
        for stage, depth in enumerate(cfg.depths):
            st = nn.Module()
            for p in range(2):
                inner, out = cfg.stage_dims(p)[stage]
                cin = s_in if p == 0 else f_in
                kt = (cfg.temp_kernels_slow if p == 0 else cfg.temp_kernels_fast)[stage]
                for j in range(depth):
                    ci = cin if j == 0 else out
                    stride = cfg.spatial_strides[stage] if j == 0 else 1
                    shortcut = j == 0 and (ci != out or cfg.spatial_strides[stage] > 1)
                    setattr(st, f"pathway{p}_res{j}", _ResBlock(ci, inner, out, kt, stride, shortcut))
                if p == 0:
                    s_in = out
                else:
                    f_in = out
            setattr(self, f"s{stage + 2}", st)
            if stage < len(cfg.depths) - 1:
                setattr(self, f"s{stage + 2}_fuse",
                        _Fuse(f_in, f_in * cfg.fusion_ratio, cfg.fusion_kernel, cfg.alpha))
                s_in += f_in * cfg.fusion_ratio

    def forward(self, slow: torch.Tensor, fast: torch.Tensor) -> list[torch.Tensor]:
        cfg = self.config
        s = self.s1.pathway0_stem(slow)
        f = self.s1.pathway1_stem(fast)
        s = self.s1_fuse(s, f)
        feats = [_layer_feature(s, f)]
        for stage, depth in enumerate(cfg.depths):
            st = getattr(self, f"s{stage + 2}")
            for j in range(depth):
                s = getattr(st, f"pathway0_res{j}")(s)
            for j in range(depth):
                f = getattr(st, f"pathway1_res{j}")(f)
            if stage < len(cfg.depths) - 1:
                s = getattr(self, f"s{stage + 2}_fuse")(s, f)
            feats.append(_layer_feature(s, f))
        return feats


def _nearest_time(x: torch.Tensor, T: int) -> torch.Tensor:
    """``F.interpolate(mode="nearest")`` along the frame axis of (B, T', C):
    index floor(t * T' / T), computed on the host in float32 as the JAX
    package computes it."""
    idx = np.floor(np.arange(T, dtype=np.float32) * np.float32(x.shape[1] / T)).astype(np.int64)
    idx = np.clip(idx, 0, x.shape[1] - 1)
    return x.index_select(1, torch.as_tensor(idx, device=x.device))


def _layer_feature(slow: torch.Tensor, fast: torch.Tensor) -> torch.Tensor:
    """LayerSlowFast.get_pool: spatial mean, slow nearest-upsampled to the
    fast frame count, channel concat -> (B, T, C)."""
    s = slow.mean(dim=(3, 4)).transpose(1, 2)   # (B, T_s, C_s)
    f = fast.mean(dim=(3, 4)).transpose(1, 2)   # (B, T_f, C_f)
    return torch.cat([_nearest_time(s, f.shape[1]), f], dim=-1)


@torch.no_grad()
def slowfast_features(model: SlowFastR50, slow: torch.Tensor, fast: torch.Tensor) -> list[torch.Tensor]:
    """(B, 3, T / alpha, H, W) slow + (B, 3, T, H, W) fast, normalised ->
    five per-stage (B, T, C) features, in full float32."""
    with full_precision():
        return model(slow, fast)


def slowfast_embed(model: SlowFastR50, slow: torch.Tensor, fast: torch.Tensor) -> torch.Tensor:
    """(B, 2304) clip embedding: the last feature level averaged over time."""
    return slowfast_features(model, slow, fast)[-1].mean(dim=1)


class SlowFastR50Extractor:
    """Video (T, H, W, 3) or (T, 3, H, W) in [0, 1] -> five (T', C) per-layer
    feature sequences: clips of ``clip_len`` frames (a video shorter than one
    clip is tiled to one), Kinetics normalisation, the model on the card
    unless ``device="cpu"``.  Without a ``model`` it draws the JAX package's
    random weights from ``RandomState(seed)``."""

    def __init__(self, model: SlowFastR50 | None = None, config: SlowFastConfig = SlowFastConfig(),
                 clip_len: int = 32, seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = (model if model is not None else init_random_params(seed, config)).to(self.device).eval()
        self.config = self.model.config
        self.clip_len = clip_len

    def __call__(self, video) -> list[torch.Tensor]:
        video = torch.as_tensor(video if torch.is_tensor(video) else np.asarray(video),
                                dtype=torch.float32).to(self.device)
        if video.ndim == 4 and video.shape[1] == 3:
            video = video.permute(0, 2, 3, 1)
        video = (video - torch.as_tensor(KINETICS_MEAN, device=self.device)) / torch.as_tensor(KINETICS_STD,
                                                                                              device=self.device)
        n = max(1, video.shape[0] // self.clip_len)
        clips = video[: n * self.clip_len]
        if clips.shape[0] < self.clip_len:  # a short video: pad by repetition
            reps = -(-self.clip_len // clips.shape[0])
            clips = clips.repeat(reps, 1, 1, 1)[: self.clip_len]
            n = 1
        clips = clips.reshape(n, self.clip_len, *clips.shape[1:]).permute(0, 4, 1, 2, 3)  # (n, 3, T, H, W)
        feats = slowfast_features(self.model, clips[:, :, :: self.config.alpha], clips)
        return [x.reshape(-1, x.shape[-1]) for x in feats]


def init_random_tree(seed: int = 0, config: SlowFastConfig = SlowFastConfig(), dtype=np.float32) -> dict:
    """The JAX package's randomly initialised tree (DHWIO kernels drawn from
    ``RandomState(seed)`` in its order), as numpy."""
    rng = np.random.RandomState(seed)
    cfg = config

    def conv(ci, co, kt, ks):
        fan = kt * ks * ks * ci
        return (rng.randn(kt, ks, ks, ci, co) * (2.0 / fan) ** 0.5).astype(dtype)

    def bn(c):
        return {"scale": np.ones(c, dtype), "bias": np.zeros(c, dtype),
                "mean": np.zeros(c, dtype), "var": np.ones(c, dtype)}

    fast_w = cfg.fast_width
    fuse_out = lambda c: c * cfg.fusion_ratio  # noqa: E731
    params = {"stem": {"0": {"conv": conv(3, cfg.width, 1, 7), "bn": bn(cfg.width)},
                       "1": {"conv": conv(3, fast_w, 5, 7), "bn": bn(fast_w)}}}

    slow_dims, fast_dims = cfg.stage_dims(0), cfg.stage_dims(1)
    fuse, stages = {}, {}
    f_in = fast_w
    s_in = cfg.width + fuse_out(fast_w)
    fuse["0"] = {"conv": conv(fast_w, fuse_out(fast_w), cfg.fusion_kernel, 1), "bn": bn(fuse_out(fast_w))}
    for stage in range(len(cfg.depths)):
        per_path = {}
        for path in range(2):
            inner, out = (slow_dims if path == 0 else fast_dims)[stage]
            cin = s_in if path == 0 else f_in
            tk = (cfg.temp_kernels_slow if path == 0 else cfg.temp_kernels_fast)[stage]
            blocks = {}
            for j in range(cfg.depths[stage]):
                ci = cin if j == 0 else out
                b = {"a": {"conv": conv(ci, inner, tk, 1), "bn": bn(inner)},
                     "b": {"conv": conv(inner, inner, 1, 3), "bn": bn(inner)},
                     "c": {"conv": conv(inner, out, 1, 1), "bn": bn(out)}}
                if j == 0 and (ci != out or cfg.spatial_strides[stage] > 1):
                    b["branch1"] = {"conv": conv(ci, out, 1, 1), "bn": bn(out)}
                blocks[str(j)] = b
            per_path[str(path)] = blocks
            if path == 0:
                s_in = out
            else:
                f_in = out
        stages[str(stage)] = per_path
        if stage < len(cfg.depths) - 1:
            fuse[str(stage + 1)] = {"conv": conv(f_in, fuse_out(f_in), cfg.fusion_kernel, 1),
                                    "bn": bn(fuse_out(f_in))}
            s_in = s_in + fuse_out(f_in)
    params["fuse"] = fuse
    params["stages"] = stages
    return params


def init_random_params(seed: int = 0, config: SlowFastConfig = SlowFastConfig()) -> SlowFastR50:
    """A randomly initialised SlowFast R50 with the JAX package's weights
    (``init_random_tree``), on the CPU."""
    from .convert_extractors import from_flax_slowfast_r50

    model = SlowFastR50(config)
    model.load_state_dict(from_flax_slowfast_r50(init_random_tree(seed, config)))
    return model.eval()
