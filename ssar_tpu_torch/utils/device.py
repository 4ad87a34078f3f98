"""Device resolution: the card unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA device.

    Raises when ``None`` is given and no CUDA device is present: entry points
    never fall back to the CPU on their own (pass ``device="cpu"`` for that).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


@contextlib.contextmanager
def full_precision():
    """Run CUDA float32 matmuls and convolutions in full float32 (no TF32).

    The feature stack's CQT, mel and resampling products are parity-critical
    (the JAX reference pins ``Precision.HIGHEST``); TF32 keeps ~3 digits.
    Restores the previous settings on exit.
    """
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
