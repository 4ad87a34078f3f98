"""S4D convolution kernels through the fused Vandermonde reduction.

Counterpart of ``ssar_tpu/ops/vandermonde.py``:

    K[h, l] = 2 * Re( sum_n  Cb[h, n] * exp(dtA[h, n] * l) )

expanded to real exp / cos / sin and reduced over N.  On a CUDA tensor
``s4d_vandermonde`` runs the hand-written kernels (``vandermonde_cuda.py``,
``csrc/s4d_vandermonde.cu``), forward and backward, and raises on a build or
launch failure.  On a CPU tensor it runs the plain version below, which
materialises the (H, N, L) tensor, and differentiates it with autograd (the
JAX backward is the VJP of its plain version too).
"""
from __future__ import annotations

import torch


def s4d_vandermonde_plain(dtA_re: torch.Tensor, dtA_im: torch.Tensor, Cb_re: torch.Tensor,
                          Cb_im: torch.Tensor, L: int) -> torch.Tensor:
    """(H, N) x4 -> real kernel (H, L), materialising (H, N, L) (any device)."""
    l = torch.arange(L, dtype=torch.float32, device=dtA_re.device)
    env = torch.exp(dtA_re[:, :, None] * l)
    re = env * (Cb_re[:, :, None] * torch.cos(dtA_im[:, :, None] * l)
                - Cb_im[:, :, None] * torch.sin(dtA_im[:, :, None] * l))
    return 2.0 * re.sum(dim=1)


class _Vandermonde(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dtA_re, dtA_im, Cb_re, Cb_im, L: int):
        ctx.save_for_backward(dtA_re, dtA_im, Cb_re, Cb_im)
        if dtA_re.is_cuda:
            from .vandermonde_cuda import s4d_vandermonde_cuda

            return s4d_vandermonde_cuda(dtA_re, dtA_im, Cb_re, Cb_im, L)
        return s4d_vandermonde_plain(dtA_re, dtA_im, Cb_re, Cb_im, L)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        if g.is_cuda:
            from .vandermonde_cuda import s4d_vandermonde_bwd_cuda

            return (*s4d_vandermonde_bwd_cuda(*inputs, g), None)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            K = s4d_vandermonde_plain(*leaves, g.shape[1])
            return (*torch.autograd.grad(K, leaves, g), None)


def s4d_vandermonde(dtA_re: torch.Tensor, dtA_im: torch.Tensor, Cb_re: torch.Tensor, Cb_im: torch.Tensor,
                    L: int) -> torch.Tensor:
    """Differentiable fused Vandermonde: (H, N) x4 float32 -> (H, L).  The kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    for t in (dtA_re, dtA_im, Cb_re, Cb_im):
        if not (t.is_cuda or t.device.type == "cpu"):
            raise ValueError(f"s4d_vandermonde runs on CUDA or CPU tensors, got {t.device}")
    return _Vandermonde.apply(dtA_re, dtA_im, Cb_re, Cb_im, L)


def zoh_factors(log_dt: torch.Tensor, A_re: torch.Tensor, A_im: torch.Tensor, C_re: torch.Tensor,
                C_im: torch.Tensor):
    """The Vandermonde's four (H, N) inputs (Re dtA, Im dtA, Re Cb, Im Cb), with
    the ZOH input factor Cb = C * (exp(dt*A) - 1) / A, in plain torch (O(H*N))."""
    dt = torch.exp(log_dt)[:, None]
    are, aim = A_re * dt, A_im * dt
    e_re = torch.exp(are) * torch.cos(aim) - 1.0
    e_im = torch.exp(are) * torch.sin(aim)
    denom = A_re**2 + A_im**2
    f_re = (e_re * A_re + e_im * A_im) / denom
    f_im = (e_im * A_re - e_re * A_im) / denom
    cb_re = C_re * f_re - C_im * f_im
    cb_im = C_re * f_im + C_im * f_re
    return are, aim, cb_re, cb_im


def s4d_kernel_fused(log_dt: torch.Tensor, A_re: torch.Tensor, A_im: torch.Tensor, C_re: torch.Tensor,
                     C_im: torch.Tensor, L: int) -> torch.Tensor:
    """Drop-in for ``models.s4.s4d_kernel`` through the fused reduction:
    ``zoh_factors``, then the O(H*N*L) Vandermonde through ``s4d_vandermonde``."""
    return s4d_vandermonde(*zoh_factors(log_dt, A_re, A_im, C_re, C_im), L)
