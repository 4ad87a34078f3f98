"""The reference's precision: float32 with TF32 off, and the control one
step below the configuration's stated precision of each stage."""
from __future__ import annotations

import torch


class tf32:
    """TF32 on or off for matmuls and cuDNN inside; the settings restored after."""

    def __init__(self, allow: bool):
        self.allow = allow

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.allow

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at the format's 448), back in float32: the control's operands
    of each synthesis convolution, a step below the stated bfloat16."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
