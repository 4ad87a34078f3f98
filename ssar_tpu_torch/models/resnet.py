"""ResNet-50 trunk (inference) — the SwAV-class extractor of the OOD metrics.

Counterpart of ``ssar_tpu/models/resnet.py``.  ``ResNet50`` is the
torchvision-layout trunk in NCHW, BatchNorm on its frozen running
statistics: a torchvision or SwAV ``state_dict`` loads into it as it is
(``models.convert_extractors.load_resnet50`` strips the ``module.`` /
``backbone.`` prefixes and the heads).  ``resnet50_features`` gives the
2048-d global-average-pooled features in full float32 (the JAX trunk pins
``Precision.HIGHEST``), and ``swav_extractor`` wraps it for
``metrics.ood.compute``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from ..utils.device import full_precision

# bottleneck counts and widths of ResNet-50
BLOCKS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm on its running statistics in every mode (any rank: 2-D and
    3-D feature maps); the parameter and buffer names of ``nn.BatchNorm2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (v1.5: the stride on the 3x3 conv)."""

    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(width * 4)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, width * 4, 1, stride, bias=False), FrozenBatchNorm(width * 4))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    """The trunk: (N, 3, H, W) ImageNet-normalised -> (N, 4 * widths[-1], h, w).
    `widths` narrows every stage (the tests' small trunks); the block counts
    are ResNet-50's."""

    def __init__(self, widths=WIDTHS):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, (n, w) in enumerate(zip(BLOCKS, widths)):
            blocks = [Bottleneck(cin if bi == 0 else w * 4, w, 2 if (bi == 0 and li > 0) else 1, bi == 0)
                      for bi in range(n)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            cin = w * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)   # pads with -inf
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


@torch.no_grad()
def resnet50_features(model: ResNet50, images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [0, 1], on the model's device -> (N, 2048) pooled
    trunk features, in full float32."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    x = ((images - mean) / std).permute(0, 3, 1, 2)
    with full_precision():
        return model(x).mean(dim=(2, 3))


def swav_extractor(model: ResNet50, resize_to: int = 224, batch_size: int = 32):
    """Extractor for ``metrics.ood.compute``: (N, H, W, 3) in [0, 1] ->
    (N, 2048) on the images' device.  Images are resized to `resize_to`
    (bilinear, antialiased as ``jax.image.resize``) and run in minibatches."""

    def extract(images: torch.Tensor) -> torch.Tensor:
        images = images.float()
        model.to(images.device)
        N, H, W, C = images.shape
        if H != resize_to or W != resize_to:
            images = resize(images, (N, resize_to, resize_to, C), method="bilinear")
        return torch.cat([resnet50_features(model, images[i : i + batch_size]) for i in range(0, N, batch_size)])

    return extract


def init_random_tree(dtype=np.float32, widths=WIDTHS) -> dict:
    """The JAX package's randomly initialised ResNet-50 tree (HWIO kernels
    drawn from ``RandomState(0)`` in its order), as numpy."""
    rng = np.random.RandomState(0)

    def conv(ci, co, k):
        return {"kernel": (rng.randn(k, k, ci, co) * np.sqrt(2.0 / (k * k * ci))).astype(dtype)}

    def bn(c):
        return {"scale": np.ones(c, dtype), "bias": np.zeros(c, dtype),
                "mean": np.zeros(c, dtype), "var": np.ones(c, dtype)}

    params = {"stem": conv(3, 64, 7), "bn1": bn(64)}
    cin = 64
    for li, (n, w) in enumerate(zip(BLOCKS, widths)):
        blocks = {}
        for bi in range(n):
            bp = {"conv1": conv(cin if bi == 0 else w * 4, w, 1), "bn1": bn(w),
                  "conv2": conv(w, w, 3), "bn2": bn(w),
                  "conv3": conv(w, w * 4, 1), "bn3": bn(w * 4)}
            if bi == 0:
                bp["downsample"] = conv(cin, w * 4, 1)
                bp["downsample_bn"] = bn(w * 4)
            blocks[str(bi)] = bp
        cin = w * 4
        params[f"layer{li + 1}"] = blocks
    return params


def init_random_params(widths=WIDTHS) -> ResNet50:
    """A randomly initialised ResNet-50 with the JAX package's weights
    (``init_random_tree``), on the CPU."""
    from .convert_extractors import from_flax_resnet50

    model = ResNet50(widths)
    model.load_state_dict(from_flax_resnet50(init_random_tree(widths=widths)))
    return model.eval()
