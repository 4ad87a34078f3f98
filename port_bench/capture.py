"""Copies of what the timed path produced, for the check after the window.

Each copy is queued on the current stream into pinned host memory and not
waited for, so the window is not held up; buffers for the tracks a window
is expected to hold are reserved during set-up."""
from __future__ import annotations

from collections import defaultdict


class Capture:
    def __init__(self):
        self.spare = defaultdict(list)   # (shape, dtype) -> pinned buffers
        self.shapes: list = []           # (shape, dtype) of each put since the last mark

    def put(self, tensor):
        import torch

        tensor = tensor.detach()
        key = (tuple(tensor.shape), tensor.dtype)
        self.shapes.append(key)
        if tensor.device.type != "cuda":
            return tensor.clone()
        buf = self.spare[key].pop() if self.spare[key] else torch.empty(key[0], dtype=key[1], pin_memory=True)
        buf.copy_(tensor, non_blocking=True)
        return buf

    def reserve(self, copies: int, shapes=None):
        """Pinned buffers for `copies` more tracks shaped as the puts since the
        last reserve (or as `shapes`)."""
        import torch

        for key in (self.shapes if shapes is None else shapes):
            for _ in range(copies):
                self.spare[key].append(torch.empty(key[0], dtype=key[1], pin_memory=torch.cuda.is_available()))
        self.shapes = []
