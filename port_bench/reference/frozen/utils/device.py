# Frozen copy of ssar_tpu_torch/utils/device.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Device resolution: the card unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA device, and
    under ``torchrun`` (``LOCAL_RANK`` set) this rank's card, ``cuda:LOCAL_RANK``,
    made the current device.

    Raises when ``None`` is given and no CUDA device is present: entry points
    never fall back to the CPU on their own (pass ``device="cpu"`` for that).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            return torch.device("cuda")
        device = torch.device("cuda", int(local))
        if torch.cuda.current_device() != device.index:
            torch.cuda.set_device(device)
        return device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


# The control (port_bench/reference/control.py) runs this stack one precision
# step below the stated one: with TF32 allowed inside ``full_precision``.
ALLOW_TF32 = False


@contextlib.contextmanager
def full_precision():
    """Run CUDA float32 matmuls and convolutions in full float32 (no TF32).

    The feature stack's CQT, mel and resampling products are parity-critical
    (the JAX reference pins ``Precision.HIGHEST``); TF32 keeps ~3 digits.
    Restores the previous settings on exit.
    """
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
