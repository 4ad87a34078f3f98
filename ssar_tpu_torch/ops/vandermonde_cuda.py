"""ctypes binding of the CUDA S4D Vandermonde kernels (csrc/s4d_vandermonde.cu).

Replaces the TPU kernel ``ssar_tpu/ops/vandermonde.py``
(``_vandermonde_kernel`` / ``s4d_vandermonde_pallas``) and, on the card, the
VJP of its plain version.  The wrappers check device, dtype and shapes,
allocate the outputs, launch on PyTorch's current stream and raise if the
launch is refused.  ``launches`` and ``bwd_launches`` count the forward and
backward launches made through them.

Every S4D layer calls these once a forward and once a backward, where the
kernels take a few microseconds, so a call does only what it needs (as
``median_cuda.py``): both entry points are resolved once, a contiguous tensor
is not passed through ``.contiguous()``, the stream is read as a raw handle,
the device guard is entered only for a tensor that is not on the current
device, and the four gradients are one allocation.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
bwd_launches = 0

_fwd_fn = None
_bwd_fn = None


def _resolve():
    """Build (at first use) and bind both entry points."""
    global _fwd_fn, _bwd_fn
    lib = _build.load("s4d_vandermonde")
    fwd, bwd = lib.ssar_s4d_vandermonde_fwd_f32, lib.ssar_s4d_vandermonde_bwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    _fwd_fn, _bwd_fn = fwd, bwd


def _check(tensors, what: str):
    shape = tensors[0].shape
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what} takes CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
        if t.shape != shape or t.ndim != 2:
            raise ValueError(f"{what} takes four (H, N) tensors of one shape, got {[tuple(x.shape) for x in tensors]}")
    if shape[0] == 0 or shape[1] == 0:
        raise ValueError(f"{what} takes non-empty (H, N) tensors")
    return [t if t.is_contiguous() else t.contiguous() for t in tensors]


def s4d_vandermonde_cuda(a: torch.Tensor, b: torch.Tensor, cre: torch.Tensor, cim: torch.Tensor,
                         L: int) -> torch.Tensor:
    """(H, N) x4 on the card -> K (H, L), float32."""
    global launches
    a, b, cre, cim = _check([a, b, cre, cim], "s4d_vandermonde_cuda")
    if L <= 0:
        raise ValueError(f"L must be positive, got {L}")
    if _fwd_fn is None:
        _resolve()
    H, N = a.shape
    out = torch.empty(H, L, device=a.device, dtype=torch.float32)
    err = _build.launch(_fwd_fn, a.device, a.data_ptr(), b.data_ptr(), cre.data_ptr(), cim.data_ptr(),
                        out.data_ptr(), H, N, L)
    if err != 0:
        raise RuntimeError(f"s4d_vandermonde forward launch failed: cudaError {err}")
    launches += 1
    return out


def s4d_vandermonde_bwd_cuda(a: torch.Tensor, b: torch.Tensor, cre: torch.Tensor, cim: torch.Tensor,
                             g: torch.Tensor):
    """Gradients (da, db, dcre, dcim), each (H, N), of sum(g * K) on the card:
    views of one (4, H, N) tensor."""
    global bwd_launches
    a, b, cre, cim = _check([a, b, cre, cim], "s4d_vandermonde_bwd_cuda")
    H, N = a.shape
    if not g.is_cuda or g.dtype != torch.float32 or g.ndim != 2 or g.shape[0] != H or g.shape[1] == 0 \
            or g.device != a.device:
        raise ValueError(f"s4d_vandermonde_bwd_cuda takes a float32 (H, L) gradient on {a.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if not g.is_contiguous():
        g = g.contiguous()
    if _bwd_fn is None:
        _resolve()
    da, db, dcre, dcim = torch.empty(4, H, N, device=a.device, dtype=torch.float32).unbind()
    err = _build.launch(_bwd_fn, a.device, a.data_ptr(), b.data_ptr(), cre.data_ptr(), cim.data_ptr(),
                        g.data_ptr(), da.data_ptr(), db.data_ptr(), dcre.data_ptr(), dcim.data_ptr(), H, N, g.shape[1])
    if err != 0:
        raise RuntimeError(f"s4d_vandermonde backward launch failed: cudaError {err}")
    bwd_launches += 1
    return da, db, dcre, dcim
