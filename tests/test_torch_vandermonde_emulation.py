"""The S4D Vandermonde CUDA source runs on the host against the plain version.

``csrc/s4d_vandermonde.cu`` compiles as plain C++ with ``-DSSAR_HOST_EMULATION``
(``csrc/host_emulation.h``: one host thread per CUDA thread, block after
block, warp shuffles as exchanges between barriers, the fast intrinsics
correctly rounded), so both kernels' index arithmetic, ragged edges, the
forward's reduce-scatter, the backward's chunked staging of g and its
fixed-order reductions, and the angle reduction with its fallback are held
against ``ops/vandermonde.py``'s plain version and its autograd where there is
no card, at the card's tolerance (rtol 1e-4, atol 1e-5 of the largest
magnitude: exp / sin / cos of the same fp32 products, summed in another
order).  The SFU's own error, whether nvcc accepts the source and how fast it
is, only the card can say (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
Needs g++ with C++20; skips without one.
"""
import ctypes

import numpy as np
import pytest
import torch
from test_torch_median_emulation import _emulated

from ssar_tpu_torch.ops.vandermonde import s4d_vandermonde_plain

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def kernels():
    lib = _emulated("s4d_vandermonde")
    fwd, bwd = lib.ssar_s4d_vandermonde_fwd_f32, lib.ssar_s4d_vandermonde_bwd_f32
    fwd.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    bwd.argtypes = [_P] * 9 + [_I] * 3 + [_P]
    fwd.restype = bwd.restype = _I
    return fwd, bwd


def _forward(fwd, args, L):
    H, N = args[0].shape
    out = torch.full((H, L), -7.0)
    assert fwd(*(t.data_ptr() for t in args), out.data_ptr(), H, N, L, None) == 0
    return out


def _backward(bwd, args, g):
    H, N = args[0].shape
    grads = torch.full((4, H, N), -7.0)
    assert bwd(*(t.data_ptr() for t in args), g.data_ptr(), *(t.data_ptr() for t in grads), H, N,
               g.shape[1], None) == 0
    return grads


def _inputs(H, N, L, seed, dt_max=0.1, far=0):
    """S4D-Lin-like inputs (a = -dt / 2, b = pi n dt, dt log-uniform in
    [1e-3, dt_max]); the first `far` columns get b ~ 1e6, so that |b l| passes
    the reduction's range (2^20) and takes the kernel's fallback."""
    rng = np.random.RandomState(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(dt_max), (H, 1)))
    a = np.repeat(-0.5 * dt, N, axis=1)
    b = np.pi * np.arange(N) * dt
    b[:, :far] = rng.uniform(0.5e6, 2e6, (H, far))
    cre, cim = rng.randn(2, H, N) * 0.05
    g = rng.randn(H, L)
    return [torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32) for x in (a, b, cre, cim)], \
        torch.as_tensor(g, dtype=torch.float32)


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()), msg=what)


CASES = [
    (3, 7, 100, {}),             # ragged H, N not a multiple of 4, L not a multiple of 64
    (2, 8, 64, {}),
    (2, 1, 5, {}),               # one n, fewer l than a warp
    (1, 13, 5000, {}),           # two chunks of g in the backward (4608 l each)
    (1, 5, 9300, {}),            # three chunks, the last one short
    (1, 64, 4320, {"dt_max": 0.1001}),  # N = 64 at a 3-minute track: |b l| up to ~8.6e4
    (2, 6, 300, {"far": 2}),     # |b l| up to ~6e8: the full-range fallback
]


@pytest.mark.parametrize("H,N,L,kw", CASES)
def test_emulated_kernels_match_plain(kernels, H, N, L, kw):
    fwd, bwd = kernels
    args, g = _inputs(H, N, L, seed=H * 1000 + N + L, **kw)
    leaves = [t.clone().requires_grad_() for t in args]
    K_plain = s4d_vandermonde_plain(*leaves, L)
    want = torch.autograd.grad(K_plain, leaves, g)
    K = _forward(fwd, args, L)
    _close(K, K_plain.detach(), "K")
    grads = _backward(bwd, args, g)
    for name, got, ref in zip(("a", "b", "cre", "cim"), grads, want):
        _close(got, ref, f"d{name}")
    assert torch.equal(_forward(fwd, args, L), K)
    assert torch.equal(_backward(bwd, args, g), grads)


def test_emulated_fallback_past_the_reduction_range(kernels):
    """Terms with |b l| beyond 2^20 agree with the plain version only through
    the fallback: the reduction alone would put them far off there.  A single
    term (N = 1) shows each l's sin and cos through K."""
    fwd, _ = kernels
    L = 64
    for b in (1000.0, 16384.0, 3.3e6, 5e8):  # |b l| up to 6.3e4, 1.0e6, 2.1e8, 3.2e10
        args = [torch.tensor([[v]]) for v in (0.0, b, 1.0, 0.5)]
        _close(_forward(fwd, args, L), s4d_vandermonde_plain(*args, L), f"b = {b}")


def test_emulated_entry_points_refuse_empty_shapes(kernels):
    fwd, bwd = kernels
    x = torch.zeros(4, 8)
    for H, N, L in ((0, 8, 10), (4, 0, 10), (4, 8, 0)):
        assert fwd(*(x.data_ptr(),) * 5, H, N, L, None) != 0
        assert bwd(*(x.data_ptr(),) * 9, H, N, L, None) != 0
