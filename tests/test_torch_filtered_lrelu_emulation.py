"""StyleGAN3's filtered-leaky-ReLU kernel (F1) runs on the host against the plain op.

``csrc/filtered_lrelu.cu`` compiles as plain C++ with ``-DSSAR_HOST_EMULATION``
(``csrc/host_emulation.h``: one host thread per CUDA thread, block after
block), so its tiles, halos, polyphase groups, strided down-filter, padding
and cropping, and its float16 storage are held against ``FilteredLReLU``'s
banded products on the CPU (``FilteredLReLU.plain``), for each of the three
classes of StyleGAN3's schedule: (up, down, up taps, down taps) = (2, 2, 12,
12), (4, 2, 24, 12) and ToRGB's (1, 1, 1, 1).  Tolerances, of the largest
magnitude of the plain op in float32 on the same values: 1e-6 in float32
(the same float32 taps, sums in another order); 1e-3 in float16, where F1
keeps the upsampled grid in float32 and rounds its result to float16 once,
while the plain op rounds the bias sum and every product's result to
float16 (held looser, 2e-3).  Whether nvcc accepts the source, and how fast
it is, only the card can say (``chip_smoke.py`` phase 3f,
``tests/test_torch_cuda.py``).  Needs g++ with C++20; skips without one.
"""
import pytest
import torch
from test_torch_median_emulation import _emulated

from ssar_tpu_torch.gan.stylegan3 import StyleGAN3Config
from ssar_tpu_torch.ops import filtered_lrelu as flr

CONFIG = StyleGAN3Config()
# one layer of each class: (2, 2) padded, (4, 2) cropped, (2, 2) cropped, ToRGB
LAYERS = {"up2": 0, "up4": 2, "up2_crop": 13, "torgb": 14}
# inputs whose outputs cross the output tiles on both axes (several blocks a plane), ragged: the tiles are
# 32 x 59 (rows x columns) for the two upsampling classes and 32 x 32 for ToRGB's
SHAPES = {"up2": (2, 3, 37, 40), "up4": (2, 3, 30, 21), "up2_crop": (1, 2, 45, 30), "torgb": (2, 3, 45, 33)}


@pytest.fixture(scope="module")
def entry():
    fn = flr.bind(_emulated("filtered_lrelu"))
    return lambda *args: fn(*args, None)


def _ops(kind, clamp=CONFIG.conv_clamp, dtype=torch.float32, channels=3):
    spec = CONFIG.schedule()[LAYERS[kind]]
    gain, slope = (1.0, 1.0) if spec.is_torgb else (2 ** 0.5, 0.2)
    args = (*CONFIG.filters(spec), spec.up, spec.down, spec.padding, gain, slope, clamp, channels)
    return flr.FilteredLReLU(*args, dtype=dtype), flr.FilteredLReLU(*args)


def _inputs(kind, seed, scale=300.0):
    """Values well past the clamp's bound (256 / sqrt 2) after upsampling."""
    g = torch.Generator().manual_seed(seed)
    shape = SHAPES[kind]
    return scale * torch.randn(shape, generator=g), torch.randn((shape[1],), generator=g)


def _gap(got, want):
    assert got.shape == want.shape
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("kind", list(LAYERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("clamp", [CONFIG.conv_clamp, None])
def test_emulated_kernel_matches_the_plain_op(entry, kind, dtype, bias, clamp):
    op, op32 = _ops(kind, clamp, dtype, SHAPES[kind][1])
    x, b = _inputs(kind, LAYERS[kind])
    x = x.to(dtype)
    b = b if bias else None
    got = op.launch(x, b, entry)
    want = op32.plain(x.float(), b)
    assert got.dtype == dtype and got.shape == op.plain(x, b).shape
    if dtype == torch.float32:
        assert _gap(got, want) <= 1e-6
    else:
        assert _gap(got, want) <= 1e-3
        assert _gap(op.plain(x, b), want) <= 2e-3
    if clamp is not None:   # the clamp took part
        assert float((want - _ops(kind, None)[1].plain(x.float(), b)).abs().max()) > 1.0


@pytest.mark.parametrize("kind", list(LAYERS))
def test_emulated_kernel_at_one_pixel_past_a_tile(entry, kind):
    """Outputs of 33 a side (one tile and one pixel), one plane, and a
    smallest input: the tile edge and the halo beyond the plane."""
    op, op32 = _ops(kind, channels=1)
    spec = CONFIG.schedule()[LAYERS[kind]]
    for n in range(4, 40):
        if op.out_size(n, n)[0] >= 33:
            break
    sizes = [(n, n)] + [(m, m + 1) for m in range(1, 12) if min(op.out_size(m, m + 1)) >= 1][:1]
    for h, w in sizes:
        x = 100 * torch.randn((1, 1, h, w), generator=torch.Generator().manual_seed(h))
        b = torch.tensor([0.5])
        assert _gap(op.launch(x, b, entry), op32.plain(x, b)) <= 1e-6, (spec.index, h, w)


@pytest.mark.parametrize("kind", ["up2", "up4", "up2_crop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_emulated_kernel_across_three_tiles_of_a_row(entry, kind, dtype):
    """Rows of at least 119 outputs: three tiles of 59 columns across, so a
    tile starts at upsampled column 118 tx; with up 4 the tile's first sample
    changes phase from one tile to the next (118 is not a multiple of 4)."""
    op, op32 = _ops(kind, dtype=dtype, channels=2)
    w = next(n for n in range(8, 200) if op.out_size(8, n)[1] >= 119)
    h = next(n for n in range(4, 60) if op.out_size(n, w)[0] >= 33)
    g = torch.Generator().manual_seed(w)
    x, b = (300.0 * torch.randn((1, 2, h, w), generator=g)).to(dtype), torch.randn((2,), generator=g)
    got, want = op.launch(x, b, entry), op32.plain(x.float(), b)
    assert -(-got.shape[-1] // 59) == 3 and got.shape[-2] > 32
    assert _gap(got, want) <= (1e-6 if dtype == torch.float32 else 1e-3)


def test_emulated_kernel_is_deterministic_and_counted(entry):
    op, _ = _ops("up4", dtype=torch.float16)
    x, b = _inputs("up4", 7)
    x = x.half()
    before = (flr.launches, flr.calls)
    first, second = op.launch(x, b, entry), op.launch(x, b, entry)
    assert torch.equal(first, second)
    assert (flr.launches - before[0], flr.calls - before[1]) == (2, 0)   # launches count; calls are __call__'s
    flr.reset_counters()
    assert (flr.launches, flr.calls, flr.least_bytes) == (0, 0, 0)


def test_cpu_calls_run_the_plain_op_and_count_no_launch():
    op, _ = _ops("up2")
    x, b = _inputs("up2", 3)
    before = (flr.calls, flr.least_bytes, flr.launches)
    y = op(x, b)
    assert torch.equal(y, op.plain(x, b))
    assert (flr.calls - before[0], flr.least_bytes - before[1], flr.launches - before[2]) == \
        (1, 4 * (x.numel() + y.numel()), 0)


def test_refusals(entry):
    op, _ = _ops("up2")
    x, b = _inputs("up2", 9)
    with pytest.raises(TypeError, match="float16"):
        _ops("up2", dtype=torch.float16)[0].launch(x, b, entry)   # a float32 input to a float16 layer
    with pytest.raises(TypeError, match="float64"):
        flr.FilteredLReLU(*CONFIG.filters(CONFIG.schedule()[0]), 2, 2, CONFIG.schedule()[0].padding, 1.4, 0.2,
                          256.0, 3, dtype=torch.float64).launch(x.double(), b, entry)
    with pytest.raises(ValueError, match="not contiguous"):
        op.launch(x.transpose(2, 3), b, entry)
    with pytest.raises(RuntimeError, match="no backward"):
        op.launch(x.clone().requires_grad_(), b, entry)
    with torch.no_grad():
        op.launch(x.clone().requires_grad_(), b, entry)
    with pytest.raises(ValueError, match="channels"):
        op.launch(x, b[:2], entry)
    with pytest.raises(ValueError, match=r"\(N, 3, H, W\)"):
        op.launch(x[:, :2].contiguous(), b, entry)
    spec = CONFIG.schedule()[0]
    fu, fd = CONFIG.filters(spec)
    for case in ((2, 2, fu[:10], fd, spec.padding),                              # other taps
                 (2, 1, fu, fd, spec.padding),                                   # another down
                 (1, 1, None, None, (1, 1, 1, 1)),                               # ToRGB's class, padded
                 (2, 2, fu, fd, spec.padding, 1.5)):                             # a slope past 1
        up, down, f_up, f_down, padding, slope = (*case, 0.2)[:6]
        odd = flr.FilteredLReLU(f_up, f_down, up, down, padding, 1.4, slope, 256.0, 3)
        with pytest.raises(ValueError, match="F1 takes"):
            odd.launch(x, b, entry)
        assert odd(x, b).shape[:2] == (2, 3)   # on the CPU every class runs the plain op
    before = flr.launches
    with pytest.raises(ValueError, match="gives no output"):
        op.launch(x[:, :, :2, :2].contiguous(), b, entry)
    assert flr.launches == before
