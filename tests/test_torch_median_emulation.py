"""The sliding-median CUDA sources run on the host against the plain versions.

``csrc/sliding_median.cu`` and ``csrc/sliding_median_bwd.cu`` compile as plain
C++ with ``-DSSAR_HOST_EMULATION`` (``csrc/host_emulation.h``: one host thread
per CUDA thread, block after block), so their index arithmetic (tiles, halo,
reflection on short lines, strides of both layouts), the shared sorting
network, the generic path for k > 31, the NaN rule and the gather's order of
adds are held against
``ops/median.py``'s plain versions bit for bit where there is no card.  The
shapes are small: a block is 256 host threads.  Whether nvcc accepts the
sources, and how fast they are, only the card can say (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  Needs g++ with C++20; skips without one.
"""
import ctypes
import hashlib
import math
import shutil
import subprocess

import pytest
import torch

from ssar_tpu_torch.ops import _build
from ssar_tpu_torch.ops.median import median_filter_plain, sliding_median_bwd_plain

OUT_DIR = _build.BUILD_DIR.parent / "emulation"


def _emulated(name: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    sources = [_build.CSRC / f"{name}.cu", *sorted(_build.CSRC.glob("*.h")), *sorted(_build.CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)).hexdigest()[:16]
    out = OUT_DIR / f"lib{name}-host-{digest}.so"
    if not out.exists():
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{id(out)}.tmp")
        proc = subprocess.run([gxx, "-x", "c++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                               "-DSSAR_HOST_EMULATION", f"-I{_build.CSRC}", "-o", str(tmp), str(sources[0])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            if "c++20" in proc.stderr or "<barrier>" in proc.stderr:
                pytest.skip("needs a g++ with C++20's <barrier>")
            raise RuntimeError(proc.stderr)
        tmp.replace(out)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def forward():
    fn = _emulated("sliding_median").ssar_sliding_median_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    return fn


@pytest.fixture(scope="module")
def backward():
    fn = _emulated("sliding_median_bwd").ssar_sliding_median_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    return fn


def _layout(x: torch.Tensor, axis: int):
    """median_cuda.line_layout without its device check."""
    from ssar_tpu_torch.ops.median_cuda import line_layout

    return line_layout(x.shape, axis % x.ndim)


def _run_forward(fn, x, k, axis):
    x = x.contiguous()
    y = torch.full_like(x, -7.0)
    assert fn(x.data_ptr(), y.data_ptr(), k, *_layout(x, axis), None) == 0
    return y


def _run_backward(fn, x, out, g, k, axis):
    x, out, g = x.contiguous(), out.contiguous(), g.contiguous()
    gx = torch.full_like(x, -7.0)
    assert fn(x.data_ptr(), out.data_ptr(), g.data_ptr(), gx.data_ptr(), k, *_layout(x, axis), None) == 0
    return gx


def _case(shape, kind, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen)
    if kind == "ties":
        x = torch.round(x * 2) / 2
        x[..., 0, :] = 1.0
    elif kind == "nan":
        flat = x.view(-1)
        flat[torch.randperm(flat.numel(), generator=gen)[: max(1, flat.numel() // 50)]] = float("nan")
    return x, torch.randn(shape, generator=gen)


SHAPES = [((37, 70), 31), ((2, 33, 40), 31), ((40, 130), 7), ((35, 66), 9), ((3, 5, 40), 1), ((6, 9), 3),
          ((6, 9), 5), ((34, 20), 15), ((5, 33), 21),
          # lines no longer than k // 2 on one axis or both
          ((40, 3), 7), ((5, 9), 31), ((2, 6, 1), 9), ((1, 1), 31), ((2, 16), 31), ((4, 15), 31), ((3, 4), 9)]


@pytest.mark.parametrize("kind", ["distinct", "ties", "nan"])
@pytest.mark.parametrize("shape,k", SHAPES)
def test_emulated_kernels_match_plain(forward, backward, shape, k, kind):
    x, g = _case(shape, kind, seed=k + math.prod(shape))
    for axis in (-1, -2):
        want = median_filter_plain(x, k, axis)
        got = _run_forward(forward, x, k, axis)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
        want_gx = sliding_median_bwd_plain(x, want, g, k, axis)
        got_gx = _run_backward(backward, x, want, g, k, axis)
        assert torch.equal(got_gx, want_gx)


@pytest.mark.parametrize("k", list(range(1, 32, 2)))
def test_emulated_forward_every_width(forward, backward, k):
    x, g = _case((9, 70), "distinct", seed=k)
    want = median_filter_plain(x, k, -1)
    assert torch.equal(_run_forward(forward, x, k, -1), want)
    assert torch.equal(_run_backward(backward, x, want, g, k, -1), sliding_median_bwd_plain(x, want, g, k, -1))
    xt = x.t().contiguous()
    assert torch.equal(_run_forward(forward, xt, k, -2), want.t())


# the generic path (k > 31): lines long and short, both layouts, batches.  Every case runs both axes, so
# (40, 7) at k = 127, (9, 30) at k = 255 and (2, 3, 4, 9) at k = 63 have lines shorter than k // 2 on each; at
# k = 545 the forward's tile (8 lines, 8 core buffers of 1,024 values) takes 55,328 bytes of shared memory and
# the backward's 75,872, above the 48 KB a launch gets without opting in.  Few tiles a case: the host runs a
# block as 256 threads.
GENERIC = [((5, 70), 33), ((3, 40), 63), ((2, 4, 37), 33), ((6, 20), 63), ((1, 1), 33),
           ((40, 7), 127), ((9, 30), 255), ((5, 40), 545), ((2, 3, 4, 9), 63)]


@pytest.mark.parametrize("kind", ["distinct", "ties", "nan"])
@pytest.mark.parametrize("shape,k", GENERIC)
def test_emulated_generic_kernels_match_plain(forward, backward, shape, k, kind):
    x, g = _case(shape, kind, seed=k + math.prod(shape))
    for axis in (-1, -2):
        want = median_filter_plain(x, k, axis)
        got = _run_forward(forward, x, k, axis)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
        assert torch.equal(_run_backward(backward, x, want, g, k, axis), sliding_median_bwd_plain(x, want, g, k, axis))


def test_emulated_entry_points_refuse_other_widths(forward, backward):
    x = torch.zeros(4, 40)
    for k in (0, 2, 34, -1):
        assert forward(x.data_ptr(), x.data_ptr(), k, *_layout(x, -1), None) != 0
        assert backward(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), k, *_layout(x, -1), None) != 0
