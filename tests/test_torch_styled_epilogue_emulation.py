"""StyleGAN2's styled-conv epilogue kernel (E1) runs on the host against the plain version.

``csrc/styled_epilogue.cu`` compiles as plain C++ with ``-DSSAR_HOST_EMULATION``
(``csrc/host_emulation.h``: one host thread per CUDA thread, block after
block), so both of its kernels, the blur's tiles, halos and runs of rows and
the pointwise kernel's vectors, scalars and noise strides, and its 16-bit
storage are held against ``styled_epilogue.plain`` (the composition of
PyTorch passes ``gan/stylegan2.py`` ran, the CPU path).  Tolerances, of the
largest magnitude of the plain version in float32 on the same values, with
the noise batched, shared by the batch (a batch stride of 0), absent, or a
batch of frames of a (1, H, W, T) map (the reactor's: no adjacent columns): 1e-6
in float32 (the same float32 taps, the separable blur and the fused
multiply-adds summing in another order); 1e-3 in float16 and 1e-2 in
bfloat16, where E1 rounds its float32 result once (half a unit in the last
place: 2^-11 and 2^-8 of the value) while the plain version rounds after
every pass.  Whether nvcc accepts the source, and how fast it is, only the
card can say (``chip_smoke.py`` phase 3g, ``tests/test_torch_cuda.py``).
Needs g++ with C++20; skips without one.
"""
import ctypes

import pytest
import torch
from test_torch_median_emulation import _emulated

from ssar_tpu_torch.ops import styled_epilogue as se

DTYPES = [torch.float32, torch.float16, torch.bfloat16]
TOL = {torch.float32: 1e-6, torch.float16: 1e-3, torch.bfloat16: 1e-2}
# (B, C, H, W) of y.  Up: the transposed conv's output, 2n + 1 a side for a 2n output (a 3 x 3 conv); the blur's
# tiles are 64 x 64 outputs, so 71 x 133 (70 x 132 out) crosses them raggedly on both axes; a plane of at most
# 8, 16 or 32 outputs a side is a subtile of a block of 64, 16 or 4 planes, and 80, 18 and 6 planes leave the
# last block ragged.  Pointwise: rows of whole 16-byte vectors (24, 16) and of none (45, 13), and the 4 x 4
# plane with many channels.
SHAPES = {"up": {"ragged": (2, 2, 71, 133), "8": (2, 40, 9, 9), "16": (2, 9, 17, 15), "32": (2, 3, 27, 33)},
          "pointwise": {"vectors": (2, 3, 17, 24), "ragged": (2, 3, 37, 45), "4x4": (2, 96, 4, 4)}}


@pytest.fixture(scope="module")
def entry():
    fn = se.bind(_emulated("styled_epilogue"))
    return lambda *args: fn(*args, None)


def _inputs(shape, dtype, *, up, noise="batch", seed=0, blur=(1, 3, 3, 1)):
    g = torch.Generator().manual_seed(seed)
    B, C = shape[:2]
    y = (3 * torch.randn(shape, generator=g)).to(dtype)
    oh, ow = se.out_shape(y, up, blur, 3)[2:]
    demod = torch.rand((B, C), generator=g) + 0.5
    bias = torch.randn((C,), generator=g)
    nw = torch.tensor(0.7)
    if noise == "batch":
        n = torch.randn((B, oh, ow, 1), generator=g).to(dtype).permute(0, 3, 1, 2)   # the synthesis's NHWC view
    elif noise == "shared":
        n = torch.randn((1, 1, oh, ow), generator=g).to(dtype)                       # batch stride 0
    elif noise == "frames_last":   # the reactor's noise: (1, H, W, T) read a batch of frames at a time
        n = torch.randn((1, oh, ow, B + 3), generator=g).to(dtype).permute(3, 0, 1, 2)[1:B + 1]
    else:
        n = None
    return y, demod, n, nw, bias


def _gap(got, want):
    assert got.shape == want.shape
    return float((got.float() - want).abs().max() / want.abs().max())


def _check(entry, inputs, dtype, **spec):
    y, demod, n, nw, bias = inputs
    got = se.launch(*inputs, entry=entry, **spec)
    want = se.plain(y.float(), demod, None if n is None else n.float(), nw, bias, **spec)
    assert got.dtype == dtype
    assert _gap(got, want) <= TOL[dtype], (dtype, spec)
    return got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("noise", ["batch", "shared", "frames_last", None])
@pytest.mark.parametrize("case", list(SHAPES["up"]))
def test_emulated_blur_matches_the_plain_version(entry, case, noise, dtype):
    inputs = _inputs(SHAPES["up"][case], dtype, up=True, noise=noise, seed=len(case))
    got, want = _check(entry, inputs, dtype, up=True)
    assert got.shape[2:] == (inputs[0].shape[2] - 1, inputs[0].shape[3] - 1)
    if noise is not None:   # the noise took part
        quiet = se.plain(inputs[0].float(), inputs[1], None, inputs[3], inputs[4], up=True)
        assert float((want - quiet).abs().max()) > 0.1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("noise", ["batch", "shared", "frames_last", None])
@pytest.mark.parametrize("case", list(SHAPES["pointwise"]))
def test_emulated_pointwise_matches_the_plain_version(entry, case, noise, dtype):
    _check(entry, _inputs(SHAPES["pointwise"][case], dtype, up=False, noise=noise, seed=len(case)), dtype, up=False)


@pytest.mark.parametrize("blur", [(1, 2, 1), (1, 3, 3, 1), (1, 4, 2), (1, 3, 5, 5, 3, 1), (1, 2, 3, 4, 5, 6, 7, 8)])
def test_emulated_blur_of_other_lengths(entry, blur):
    """The generic path (a runtime tap count up to 8, a halo of 7) and the
    4-tap one, against upfirdn2d's padding and the flipped outer-product
    kernel; an uneven blur shows a missing flip."""
    inputs = _inputs((1, 2, 67, 70), torch.float32, up=True, seed=len(blur), blur=blur)
    _check(entry, inputs, torch.float32, up=True, blur_kernel=blur)


@pytest.mark.parametrize("up", [True, False])
def test_emulated_reads_unaligned_tensors(entry, up):
    """y and the noise one sample past a 16-byte boundary (views into a
    larger storage): the blur's chunks start from the boundary before y, the
    pointwise kernel and the noise reads go one sample at a time."""
    y, demod, n, nw, bias = _inputs((2, 3, 17, 24), torch.bfloat16, up=up, seed=7)
    y2 = torch.empty(y.numel() + 1, dtype=y.dtype)[1:].view(y.shape).copy_(y)
    n2 = torch.empty(n.numel() + 1, dtype=n.dtype)[1:].view(n.shape).copy_(n)
    assert y2.data_ptr() % 16 and n2.data_ptr() % 16
    got = se.launch(y2, demod, n2, nw, bias, up=up, entry=entry)
    assert torch.equal(got, se.launch(y, demod, n, nw, bias, up=up, entry=entry))
    _check(entry, (y2, demod, n2, nw, bias), torch.bfloat16, up=up)


@pytest.mark.parametrize("up", [True, False])
def test_emulated_takes_a_channels_last_y(entry, up):
    """A channels-last y, as cuDNN returns for a channels-last input (the
    synthesis's first layer when its const was loaded in the JAX layout),
    gives the contiguous y's output."""
    y, demod, n, nw, bias = _inputs((2, 3, 17, 17), torch.bfloat16, up=up, seed=9)
    last = y.to(memory_format=torch.channels_last)
    assert not last.is_contiguous()
    assert torch.equal(se.launch(last, demod, n, nw, bias, up=up, entry=entry),
                       se.launch(y, demod, n, nw, bias, up=up, entry=entry))


def test_emulated_without_demod_or_bias_and_counted(entry):
    y, _, n, nw, _ = _inputs((2, 3, 17, 17), torch.float32, up=True, seed=5)
    _check(entry, (y, None, n, nw, None), torch.float32, up=True)
    before = (se.launches, se.calls)
    first = se.launch(y, None, n, nw, None, up=True, entry=entry)
    assert torch.equal(first, se.launch(y, None, n, nw, None, up=True, entry=entry))
    assert (se.launches - before[0], se.calls - before[1]) == (2, 0)   # launches count; calls are the op's
    se.reset_counters()
    assert (se.launches, se.calls, se.least_bytes) == (0, 0, 0)


@pytest.mark.parametrize("up", [True, False])
def test_cpu_calls_run_the_plain_version_and_count_no_launch(up):
    y, demod, n, nw, bias = _inputs((2, 3, 9, 9), torch.bfloat16, up=up)
    before = (se.calls, se.least_bytes, se.launches)
    out = se.styled_epilogue(y, demod, n, nw, bias, up=up)
    assert torch.equal(out, se.plain(y, demod, n, nw, bias, up=up))
    assert (se.calls - before[0], se.least_bytes - before[1], se.launches - before[2]) == \
        (1, 2 * (y.numel() + out.numel() + n.numel()), 0)


def test_launch_taps_are_built_once_a_blur():
    taps = se.launch_taps((1, 3, 3, 1))
    assert se.launch_taps([1, 3, 3, 1]) is taps
    assert list(taps) == [0.25, 0.75, 0.75, 0.25]
    assert list(se.launch_taps((1, 2, 3))) == pytest.approx([1.0, 2 / 3, 1 / 3], rel=1e-7)   # flipped


def test_refusals(entry):
    y, demod, n, nw, bias = _inputs((2, 3, 9, 9), torch.float32, up=True)
    with pytest.raises(TypeError, match="float64"):
        se.launch(y.double(), demod, n, nw, bias, up=True, entry=entry)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        se.launch(y[0], demod, n, nw, bias, up=True, entry=entry)
    with pytest.raises(ValueError, match="1 to 8 taps"):
        se.launch(y, demod, n, nw, bias, up=True, blur_kernel=(1,) * 9, entry=entry)
    with pytest.raises(ValueError, match="demod"):
        se.launch(y, demod.double(), n, nw, bias, up=True, entry=entry)
    with pytest.raises(ValueError, match="bias"):
        se.launch(y, demod, n, nw, bias[:2], up=True, entry=entry)
    with pytest.raises(ValueError, match="noise_weight"):
        se.launch(y, demod, n, nw.double(), bias, up=True, entry=entry)
    with pytest.raises(ValueError, match="a noise of"):
        se.launch(y, demod, n[:, :, :4], nw, bias, up=True, entry=entry)
    with pytest.raises(ValueError, match="gives no output"):
        se.launch(y[:, :, :1, :1].contiguous(), demod, None, nw, bias, up=True, blur_kernel=(1,) * 8, entry=entry)
    assert isinstance(se.launch_taps((1, 3, 3, 1)), ctypes.Array)
