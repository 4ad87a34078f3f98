"""ctypes binding of the CUDA S4D Vandermonde kernels (csrc/s4d_vandermonde.cu).

Replaces the TPU kernel ``ssar_tpu/ops/vandermonde.py``
(``_vandermonde_kernel`` / ``s4d_vandermonde_pallas``) and, on the card, the
VJP of its plain version.  The wrappers check device, dtype and shapes,
allocate the outputs, launch on PyTorch's current stream and raise if the
launch is refused.  ``launches`` and ``bwd_launches`` count the forward and
backward launches made through them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
bwd_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("s4d_vandermonde")
    if lib.ssar_s4d_vandermonde_fwd_f32.argtypes is None:
        lib.ssar_s4d_vandermonde_fwd_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.ssar_s4d_vandermonde_fwd_f32.restype = _I
        lib.ssar_s4d_vandermonde_bwd_f32.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.ssar_s4d_vandermonde_bwd_f32.restype = _I
    return lib


def _check(tensors, what: str):
    shape = tensors[0].shape
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what} takes CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
        if t.ndim != 2 or t.shape != shape:
            raise ValueError(f"{what} takes four (H, N) tensors of one shape, got {[tuple(x.shape) for x in tensors]}")
    if shape[0] == 0 or shape[1] == 0:
        raise ValueError(f"{what} takes non-empty (H, N) tensors")
    if shape[1] > 1536:  # 4 x 2 rows x N floats of shared memory must fit in 48 KB
        raise ValueError(f"{what} takes N <= 1536, got {shape[1]}")
    return [t.contiguous() for t in tensors]


def s4d_vandermonde_cuda(a: torch.Tensor, b: torch.Tensor, cre: torch.Tensor, cim: torch.Tensor,
                         L: int) -> torch.Tensor:
    """(H, N) x4 on the card -> K (H, L), float32."""
    global launches
    a, b, cre, cim = _check([a, b, cre, cim], "s4d_vandermonde_cuda")
    if L <= 0:
        raise ValueError(f"L must be positive, got {L}")
    H, N = a.shape
    out = torch.empty(H, L, device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        err = _lib().ssar_s4d_vandermonde_fwd_f32(a.data_ptr(), b.data_ptr(), cre.data_ptr(), cim.data_ptr(),
                                                  out.data_ptr(), H, N, L,
                                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"s4d_vandermonde forward launch failed: cudaError {err}")
    launches += 1
    return out


def s4d_vandermonde_bwd_cuda(a: torch.Tensor, b: torch.Tensor, cre: torch.Tensor, cim: torch.Tensor,
                             g: torch.Tensor):
    """Gradients (da, db, dcre, dcim), each (H, N), of sum(g * K) on the card."""
    global bwd_launches
    a, b, cre, cim = _check([a, b, cre, cim], "s4d_vandermonde_bwd_cuda")
    H, N = a.shape
    if not g.is_cuda or g.dtype != torch.float32 or g.ndim != 2 or g.shape[0] != H or g.shape[1] == 0:
        raise ValueError(f"s4d_vandermonde_bwd_cuda takes a float32 CUDA (H, L) gradient, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    g = g.contiguous()
    L = g.shape[1]
    da, db, dcre, dcim = (torch.empty_like(a) for _ in range(4))
    with torch.cuda.device(a.device):
        err = _lib().ssar_s4d_vandermonde_bwd_f32(a.data_ptr(), b.data_ptr(), cre.data_ptr(), cim.data_ptr(),
                                                  g.data_ptr(), da.data_ptr(), db.data_ptr(), dcre.data_ptr(),
                                                  dcim.data_ptr(), H, N, L,
                                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"s4d_vandermonde backward launch failed: cudaError {err}")
    bwd_launches += 1
    return da, db, dcre, dcim
