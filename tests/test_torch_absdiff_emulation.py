"""The absdiff CUDA source runs on the host against the plain version.

``csrc/absdiff.cu`` compiles as plain C++ with ``-DSSAR_HOST_EMULATION``
(``csrc/host_emulation.h``: one host thread per CUDA thread, block after
block, 16-bit float storage with exact widening and round-to-nearest-even
narrowing), so the plan, the chunk and slice arithmetic, the split plan's
ticket and fixed-order sum, the ragged-E / misaligned scalar route and the
half-type reads are held against ``ops/absdiff.py``'s plain version where
there is no card: float32 at rtol 1e-5 (float32 sums of positive terms in
another order), float16 / bfloat16 within one unit in the last place of the
float32 plain result cast, exactly where every sum is exact, and two runs
bit for bit.  The entry point takes the SM count its plan aims at: a small
one forces split plans at small shapes.  Whether nvcc accepts the source and
how fast it is, only the card can say (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  Needs g++ with C++20; skips without one.
"""
import math

import pytest
import torch
from test_torch_median_emulation import _emulated

from ssar_tpu_torch.ops.absdiff import batch_absdiff_plain
from ssar_tpu_torch.ops.absdiff_cuda import DTYPE_CODES, bind, plan_of


@pytest.fixture(scope="module")
def lib():
    return bind(_emulated("absdiff"))


def _plan(lib, shape, dtype, sms, aligned=True) -> dict:
    return plan_of(lib[2], shape, dtype, aligned, sms)


def _run(lib, x, sms):
    fn, scratch_bytes, _ = lib
    counters = 16 * sms  # the scratch's ticket counters (csrc/absdiff.cu counter_bytes)
    scratch = torch.zeros(scratch_bytes(sms), dtype=torch.uint8)
    y = torch.full(x.shape[:2], -7.0, dtype=x.dtype)
    assert fn(x.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype], x.shape[0], x.shape[1], x[0, 0].numel(), sms,
              scratch.data_ptr(), scratch.numel(), None) == 0
    assert not scratch[:counters].any(), "a ticket counter was left set"
    return y


def _check(lib, x, sms):
    got, again = _run(lib, x, sms), _run(lib, x, sms)
    assert torch.equal(got, again)
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, batch_absdiff_plain(x), rtol=1e-5, atol=0)
    else:
        want = batch_absdiff_plain(x.float()).to(x.dtype).float()
        assert ((got.float() - want).abs() <= torch.finfo(x.dtype).eps * want.abs()).all()
    return got


# (shape, dtype, sms, the plan's (vec, tc, slices))
CASES = [
    ((3, 33, 40), torch.float32, 1, (1, 16, 1)),       # S = 1, two whole chunks
    ((3, 30, 40), torch.float32, 1, (1, 16, 1)),       # S = 1, T - 1 not a multiple of TC
    ((4, 12, 64), torch.float32, 2, (1, 8, 1)),        # TC = 8 where that fills the card
    ((2, 192, 16), torch.float32, 8, (1, 8, 1)),       # a noise map's rows: 32 threads a block
    ((1, 20, 12288), torch.float32, 1, (1, 16, 4)),    # split, a ragged last chunk
    ((2, 10, 6144), torch.float32, 2, (1, 16, 2)),     # split, B > 1
    ((1, 2, 6144), torch.float32, 1, (1, 8, 2)),       # split, T = 2
    ((3, 2, 64), torch.float32, 1, (1, 8, 1)),         # T = 2
    ((2, 13, 1001), torch.float32, 1, (0, 8, 1)),      # E not a multiple of 4: one element a unit
    ((1, 12, 2050), torch.float32, 1, (0, 16, 2)),     # the same, split, a short last slice
    ((2, 20, 4096), torch.float16, 1, (1, 16, 1)),     # 8 halves a unit
    ((1, 20, 12288), torch.float16, 1, (1, 16, 2)),
    ((2, 9, 999), torch.float16, 1, (0, 8, 1)),
    ((2, 20, 4096), torch.bfloat16, 1, (1, 16, 1)),
    ((1, 20, 12288), torch.bfloat16, 1, (1, 16, 2)),
    ((1, 11, 4100), torch.bfloat16, 1, (0, 16, 4)),    # 8200 bytes a row: not a multiple of 16
]


@pytest.mark.parametrize("shape,dtype,sms,plan", CASES)
def test_emulated_kernel_matches_plain(lib, shape, dtype, sms, plan):
    assert tuple(_plan(lib, shape, dtype, sms)[k] for k in ("vec", "tc", "slices")) == plan
    gen = torch.Generator().manual_seed(math.prod(shape) + sms)
    _check(lib, torch.randn(shape, generator=gen).to(dtype), sms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_emulated_misaligned_base_takes_the_scalar_route(lib, dtype):
    """A contiguous view 4 (2) bytes past an aligned base: element units, the same sums."""
    shape = (1, 10, 4096)
    flat = torch.randn(math.prod(shape) + 1, generator=torch.Generator().manual_seed(5)).to(dtype)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    assert _plan(lib, shape, dtype, 1, aligned=False)["vec"] == 0
    assert _plan(lib, shape, dtype, 1)["vec"] == 1
    _check(lib, x, 1)


@pytest.mark.parametrize("shape", [(1, 9, 12288), (2, 5, 24)])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_emulated_half_rounding_is_exact(lib, dtype, shape):
    """Integer-valued inputs: every float32 sum is exact in any order, so the
    result equals the plain version's cast bit for bit, including the sums the
    dtype rounds to nearest even (above 2048 in float16, 256 in bfloat16) and,
    scaled by 2^-24 (float16) or 2^-130 (bfloat16), subnormal inputs and
    results.  (1, 9, 12288) takes a split plan."""
    ints = torch.randint(-4, 5, shape, generator=torch.Generator().manual_seed(7)).float()
    for xf in (ints, ints * 2.0 ** (-24 if dtype == torch.float16 else -130)):
        x = xf.to(dtype)
        assert torch.equal(x.float(), xf)  # the inputs are exact in the dtype
        assert torch.equal(_run(lib, x, 1), batch_absdiff_plain(xf).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_emulated_half_ties_round_to_even(lib, dtype):
    """Rows alternate between zeros and a row of one 2^11 (float16) or 2^8
    (bfloat16) and m ones: every sum 2^p + m is exact in float32 and, for odd
    m, halfway between two neighbours in the dtype; it must round to the even
    one, as `.to(dtype)` does."""
    big = 2048.0 if dtype == torch.float16 else 256.0
    x = torch.zeros(1, 16, 64)
    for t in range(1, 16, 2):
        x[0, t, 0] = big
        x[0, t, 1:2 * t] = 1.0
    want = batch_absdiff_plain(x).to(dtype)
    assert not torch.equal(want.float(), batch_absdiff_plain(x)), "no sum rounds"
    assert torch.equal(_run(lib, x.to(dtype), 1), want)


def test_plan_at_path_shapes(lib):
    """At the card's 132 SMs: the train loss's (32, 192, E) shapes fill the
    card with their chunks (S = 1); the evaluation's few long rows split."""
    for E in (18 * 512, 1024, 256, 64, 16):
        assert _plan(lib, (32, 192, E), torch.float32, 132)["slices"] == 1
    assert _plan(lib, (32, 192, 18 * 512), torch.float16, 132)["slices"] == 1
    long_rows = _plan(lib, (1, 192, 3 * 1024 * 1024), torch.float32, 132)
    assert (long_rows["tc"], long_rows["chunks"], long_rows["slices"]) == (16, 12, 342)
    assert _plan(lib, (1, 1440, 3 * 256 * 256), torch.float32, 132)["slices"] > 1


def test_scratch_too_small_is_refused(lib):
    fn, scratch_bytes, _ = lib
    x = torch.randn(1, 4, 64)
    y = torch.empty(1, 4)
    scratch = torch.zeros(scratch_bytes(8) - 4, dtype=torch.uint8)
    assert fn(x.data_ptr(), y.data_ptr(), 0, 1, 4, 64, 8, scratch.data_ptr(), scratch.numel(), None) != 0
