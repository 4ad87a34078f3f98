"""Port ops vs the JAX package's ops, on the CPU, from the same numpy inputs.

Tolerances: the median is exact (it selects an input element), and so is its
gradient against ``jax.vjp`` of the Pallas kernel (both route each cotangent
to the first equal tap and add the taps in ascending order); the float32
filters are held at rtol 1e-5 with an atol of 1e-5 of the output's scale
(sums taken in another order); quantiles select and interpolate the same
order statistics and are held at 1e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

j_dct = importlib.import_module("ssar_tpu.ops.dct")
j_gauss = importlib.import_module("ssar_tpu.ops.gaussian")
j_iir = importlib.import_module("ssar_tpu.ops.iir")
j_q = importlib.import_module("ssar_tpu.ops.quantile")
j_rs = importlib.import_module("ssar_tpu.ops.resample")
j_up = importlib.import_module("ssar_tpu.ops.upfirdn")
from ssar_tpu.ops.median import median_filter as j_median
from ssar_tpu.ops.median_pallas import sliding_median_lastaxis
from ssar_tpu_torch.audio.spectral import reflect_pad
from ssar_tpu_torch.ops import dct as t_dct
from ssar_tpu_torch.ops import gaussian as t_gauss
from ssar_tpu_torch.ops import iir as t_iir
from ssar_tpu_torch.ops import quantile as t_q
from ssar_tpu_torch.ops import resample as t_rs
from ssar_tpu_torch.ops import upfirdn as t_up
from ssar_tpu_torch.ops.median import median_filter, median_filter_plain, sliding_median_bwd_plain


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * (np.abs(want).max() + 1e-30))


# ------------------------------------------------------------------ median --
@pytest.mark.parametrize("shape,k,axis", [((16, 48), 7, -1), ((16, 48), 7, 0), ((16, 48), 31, -1),
                                          ((40, 48), 31, 0), ((3, 16, 48), 7, -1), ((3, 40, 20), 31, 1),
                                          ((6, 16, 48), 9, 0)])
def test_median_plain_matches_jax(rng, shape, k, axis):
    x = rng.rand(*shape).astype(np.float32)
    got = median_filter(torch.as_tensor(x), k, axis)
    assert torch.equal(got, median_filter_plain(torch.as_tensor(x), k, axis))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_median(jnp.asarray(x), k, axis)))


@pytest.mark.parametrize("k", [7, 31])
def test_median_matches_pallas_kernel_interpret(rng, k):
    x = rng.rand(2, 16, 48).astype(np.float32)
    got = median_filter(torch.as_tensor(x), k, -1).numpy()
    for b in range(2):  # the Pallas kernel is 2-D: one call per batch row
        np.testing.assert_array_equal(got[b], np.asarray(sliding_median_lastaxis(jnp.asarray(x[b]), k)))
        np.testing.assert_array_equal(
            median_filter(torch.as_tensor(x[b]), k, 0).numpy()[:, :16],
            np.asarray(sliding_median_lastaxis(jnp.asarray(x[b].T), k)).T[:, :16])


def _median_case(rng, shape, kind):
    x = rng.randn(*shape).astype(np.float32)
    if kind == "ties":      # quantised values and a constant row: most windows hold tied taps
        x = np.round(x * 2) / 2
        x[0] = 1.0
    elif kind == "nan":
        x[1, shape[1] // 2] = np.nan
    return x


@pytest.mark.parametrize("kind", ["distinct", "ties", "nan"])
@pytest.mark.parametrize("k,shape", [(3, (4, 24)), (7, (6, 40)), (9, (5, 9)), (31, (3, 33)), (31, (2, 16))])
def test_median_backward_plain_matches_pallas_vjp(rng, k, shape, kind):
    """The port's first-equal-tap rule against ``jax.vjp`` of the Pallas
    kernel in interpret mode, through ``median_filter`` along both axes.  A
    window holding a NaN gives NaN in both (NaNs in the same places); no tap
    equals it, and that case compares the gradient away from the NaN's
    windows."""
    x = _median_case(rng, shape, kind)
    g = rng.randn(*shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: sliding_median_lastaxis(a, k), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    for axis, arr, cot in ((1, x, g), (0, x.T.copy(), g.T.copy())):
        xt = torch.as_tensor(arr).requires_grad_()
        out = median_filter(xt, k, axis)
        assert out.grad_fn is not None
        (got,) = torch.autograd.grad(out, xt, torch.as_tensor(cot))
        got = got.numpy() if axis == 1 else got.numpy().T
        if kind == "nan":
            col = shape[1] // 2
            far = np.abs(np.arange(shape[1]) - col) > 2 * (k // 2)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[2:], want[2:])
            np.testing.assert_array_equal(got[1, far], want[1, far])
            assert np.isfinite(got[:, np.arange(shape[1]) != col]).all()
            out_np = out.detach().numpy() if axis == 1 else out.detach().numpy().T
            np.testing.assert_array_equal(out_np, np.asarray(out_j))
            assert np.isnan(out_np[1, max(0, col - k // 2) : col + k // 2 + 1]).all() and np.isnan(out_np).sum() <= k
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(out.detach().numpy() if axis == 1 else out.detach().numpy().T,
                                          np.asarray(out_j))
    # the rule itself: every cotangent lands somewhere, once
    if kind != "nan":
        np.testing.assert_allclose(want.sum(axis=1), g.sum(axis=1), rtol=1e-4, atol=1e-4)


def test_median_backward_matches_sort_gradient_without_ties(rng):
    """Against the gradient of ``jnp.median`` over the stacked windows (the JAX
    package's path off the TPU), on distinct values, where every subgradient
    rule agrees; sums of the same cotangents in another order: atol 1e-5."""
    x = rng.randn(8, 40).astype(np.float32)
    w = jnp.arange(40, dtype=jnp.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.cos(j_median(a, 7, axis=1)) * w))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    (torch.cos(median_filter(xt, 7, 1)) * torch.arange(40.0)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5)
    # batched, along the axis before the last, through a moved axis
    x3 = torch.as_tensor(rng.randn(3, 12, 5, 4).astype(np.float32)).requires_grad_()
    want3 = jax.grad(lambda a: jnp.sum(j_median(a, 5, axis=1) ** 2))(jnp.asarray(x3.detach().numpy()))
    (median_filter(x3, 5, 1) ** 2).sum().backward()
    np.testing.assert_allclose(x3.grad.numpy(), np.asarray(want3), atol=1e-5)


def test_median_filter_gradient_is_its_own_rule(rng):
    """``median_filter`` differentiates by the Function's rule on the CPU path,
    not ``torch.median``'s: on a constant row the whole cotangent of a window
    goes to its first tap, and finite differences agree where taps are distinct."""
    x = torch.ones(1, 12, requires_grad=True)
    out = median_filter(x, 5)
    assert type(out.grad_fn).__name__ == "_SlidingMedianBackward"
    (gx,) = torch.autograd.grad(out, x, torch.ones(1, 12))
    # window t starts at padded position t: tap 0 is x[t - 2], reflected at the left edge
    want = np.zeros(12, np.float32)
    for t in range(12):
        want[abs(t - 2)] += 1.0
    np.testing.assert_array_equal(gx.numpy()[0], want)
    direct = sliding_median_bwd_plain(x.detach(), out.detach(), torch.ones(1, 12), 5)
    np.testing.assert_array_equal(direct.numpy()[0], want)

    xd = torch.as_tensor(rng.permutation(60).reshape(3, 20).astype(np.float64), dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(lambda a: median_filter(a, 7, -1), (xd,), eps=1e-3, atol=1e-6)
    assert torch.autograd.gradcheck(lambda a: median_filter(a, 5, 0), (xd,), eps=1e-3, atol=1e-6)


SHORT = [(k, L) for k in (7, 9, 31) for L in (1, 2, 3, k // 2)]


@pytest.mark.parametrize("k,L", SHORT)
def test_median_plain_short_lines_match_jax(rng, k, L):
    """Lines no longer than k // 2: the padding keeps reflecting (a triangle
    wave of period 2(L - 1); L = 1 repeats the sample) as ``jnp.pad`` does in
    the JAX package's path off the TPU.  Exact: a selection."""
    for shape, axis in (((3, 6, L), -1), ((3, L, 6), 1), ((L,), 0), ((2, L, 3, 2), 1)):
        x = rng.randn(*shape).astype(np.float32)
        got = median_filter(torch.as_tensor(x), k, axis)
        assert torch.equal(got, median_filter_plain(torch.as_tensor(x), k, axis))
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_median(jnp.asarray(x), k, axis)))


@pytest.mark.parametrize("k,L", SHORT)
def test_median_backward_plain_short_lines_match_jax_grad(rng, k, L):
    """The gradient on short lines against ``jax.grad`` of the JAX package's
    path off the TPU (the Pallas VJP's fold assumes a pad shorter than the
    line), on distinct values, where every subgradient rule agrees; every
    padded position that mirrors an input contributes, summed in another
    order: atol 1e-5."""
    for shape, axis in (((3, 6, L), -1), ((3, L, 6), 1)):
        x = rng.randn(*shape).astype(np.float32)
        w = rng.randn(*shape).astype(np.float32)
        want = jax.grad(lambda a: jnp.sum(j_median(a, k, axis=axis) * w))(jnp.asarray(x))
        xt = torch.as_tensor(x).requires_grad_()
        (median_filter(xt, k, axis) * torch.as_tensor(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5)
        # every cotangent lands somewhere, once
        np.testing.assert_allclose(xt.grad.numpy().sum(axis), w.sum(axis), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,k,axis", [((4, 12), 7, -1), ((12, 4), 7, 0), ((3, 40), 31, -1), ((2, 5, 9), 9, 1),
                                          ((2, 3), 7, -1)])
def test_median_window_with_nan_matches_jax(rng, shape, k, axis):
    """A window holding a NaN gives NaN, as ``jnp.median`` over the stacked
    windows does: NaNs in the same places, every other value equal."""
    x = rng.randn(*shape).astype(np.float32)
    x.reshape(-1)[[x.size // 3, x.size - 2]] = np.nan
    got = median_filter(torch.as_tensor(x), k, axis).numpy()
    want = np.asarray(j_median(jnp.asarray(x), k, axis))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() and (not np.isnan(got).all() or min(shape) <= k // 2)


def test_segmentation_of_a_clip_with_three_beat_synchronous_frames_matches_jax():
    """Three beat-synchronous frames: both of the segmentation's medians (7
    taps on the (6, 3) lag matrix, 9 taps on the (3, 3) eigenvectors) pad
    lines of 3 by 3 and 4.  Values within 1e-4 of the JAX package's, and the
    gradient flows."""
    j_seg = importlib.import_module("ssar_tpu.audio.segment")
    from ssar_tpu_torch.audio import segment as t_seg

    rng = np.random.RandomState(0)
    env = (np.repeat(rng.randn(3, 5) * 2, 8, axis=0) + 0.1 * rng.randn(24, 5)).astype(np.float32)
    beats, ks = [8, 16], (2, 4)
    want = j_seg.laplacian_segmentation(jnp.asarray(env), beats, ks=ks)
    et = torch.as_tensor(env).requires_grad_()
    got = t_seg.laplacian_segmentation(et, beats, ks=ks)
    for g, w, k in zip(got, want, ks):
        assert tuple(g.shape) == (24, k) and bool(torch.isfinite(g).all())
        _close(g.detach(), w, 1e-4)
    sum((s * torch.arange(s.shape[1])).sum() for s in got).backward()
    assert bool(torch.isfinite(et.grad).all())


def test_median_rejects_other_modes():
    """Modes outside ``PAD_MODES`` (``np.pad``'s statistics and ramps, which
    no caller uses) and even widths."""
    for mode in ("linear_ramp", "maximum", "mean"):
        with pytest.raises(ValueError):
            median_filter(torch.zeros(4, 9), 3, mode=mode)
    with pytest.raises(ValueError):
        median_filter(torch.zeros(4, 9), 4)


@pytest.mark.parametrize("mode", ["constant", "edge", "symmetric", "wrap", "reflect"])
@pytest.mark.parametrize("shape,k,axis", [((6, 40), 7, -1), ((30, 5), 9, 0), ((2, 3, 20), 5, 1), ((4, 3), 7, -1)])
def test_median_modes_match_jax(rng, mode, shape, k, axis):
    """Every padding mode against the JAX package's pad-and-window median:
    exact forward; on distinct values (no ties, so every subgradient rule
    agrees) the gradient within 1e-5 of ``jax.grad`` (the pad's fold adds in
    another order); lines shorter than the pad included."""
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    got = median_filter(torch.as_tensor(x), k, axis, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_median(jnp.asarray(x), k, axis, mode=mode)))
    want = jax.grad(lambda a: jnp.sum(j_median(a, k, axis=axis, mode=mode) * w))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    (median_filter(xt, k, axis, mode=mode) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("k", [33, 63])
def test_median_wide_windows_match_jax(rng, k):
    """Odd k > 31 (the generic kernels' widths on the card): exact forward on
    both axes, and the gradient within 1e-5 of ``jax.grad`` on distinct values
    (up to 63 contributions an input, added in another order)."""
    x = rng.randn(40, 70).astype(np.float32)
    w = rng.randn(40, 70).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(median_filter(torch.as_tensor(x), k, axis).numpy(),
                                      np.asarray(j_median(jnp.asarray(x), k, axis)))
        want = jax.grad(lambda a: jnp.sum(j_median(a, k, axis=axis) * w))(jnp.asarray(x))
        xt = torch.as_tensor(x).requires_grad_()
        (median_filter(xt, k, axis) * torch.as_tensor(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("mode", ["reflect", "edge"])
def test_median_half_dtypes_match_jax(rng, dtype, mode):
    """Half-precision inputs: the same bits as the JAX package's median in
    that dtype (a selection; the reflect path makes an exact float32 round
    trip), and a gradient of the input's dtype equal to the float32
    gradient's cast on distinct values."""
    x = rng.randn(12, 50).astype(np.float32)
    xh = torch.as_tensor(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xh.float().numpy()).astype(getattr(jnp, dtype))
    for k, axis in ((7, -1), (31, 0), (33, -1)):
        got = median_filter(xh, k, axis, mode=mode)
        assert got.dtype == xh.dtype
        want = np.asarray(j_median(xj, k, axis, mode=mode).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)
    leaf = xh.clone().requires_grad_()
    (gx,) = torch.autograd.grad(median_filter(leaf, 9, -1, mode=mode), leaf, torch.ones_like(xh))
    leaf32 = xh.float().requires_grad_()
    (gx32,) = torch.autograd.grad(median_filter(leaf32, 9, -1, mode=mode), leaf32, torch.ones(12, 50))
    assert gx.dtype == xh.dtype and torch.equal(gx, gx32.to(xh.dtype))


# ----------------------------------------------------------------- filters --
@pytest.mark.parametrize("shape,sigma,mode", [((50,), 2.0, "circular"), ((50, 3), 10.0, "circular"),
                                              ((12, 2, 4, 4), 5.0, "circular"), ((30, 4), 3.0, "reflect")])
def test_gaussian_filter(rng, shape, sigma, mode):
    x = rng.randn(*shape).astype(np.float32)
    got = t_gauss.gaussian_filter(torch.as_tensor(x), sigma, mode)
    want = j_gauss.gaussian_filter(jnp.asarray(x), sigma, mode)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("kind,cutoff", [("lowpass", 200.0), ("highpass", 4000.0)])
def test_biquad(rng, kind, cutoff):
    sr = 24576
    x = rng.randn(2, 3000).astype(np.float32)  # > one block level of the recurrence
    b, a = t_iir.biquad_coeffs(kind, sr, cutoff)
    got = t_iir.biquad_apply(torch.as_tensor(x), b, a)
    want = j_iir.biquad_apply(jnp.asarray(x), tuple(b), tuple(a))
    _close(got, want)


def test_mid_pass(rng):
    x = rng.randn(70000).astype(np.float32)  # three levels of blocks
    _close(t_iir.mid_pass(torch.as_tensor(x), 24576), j_iir.mid_pass(jnp.asarray(x), 24576))


@pytest.mark.parametrize("orig,new,width", [(44100, 24576, 6), (2, 1, 6), (16000, 24576, 16)])
def test_resample(rng, orig, new, width):
    x = rng.randn(4000).astype(np.float32)
    got = t_rs.resample(torch.as_tensor(x), orig, new, lowpass_filter_width=width)
    want = j_rs.resample(jnp.asarray(x), orig, new, lowpass_filter_width=width)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct(rng, norm):
    x = rng.randn(5, 128).astype(np.float32)
    _close(t_dct.dct(torch.as_tensor(x), norm=norm), j_dct.dct(jnp.asarray(x), norm=norm))


@pytest.mark.parametrize("L,left,right", [(10, 3, 3), (5, 12, 7), (2, 3, 1)])
def test_reflect_pad_matches_numpy(L, left, right):
    x = np.arange(L, dtype=np.float32)
    np.testing.assert_array_equal(reflect_pad(torch.as_tensor(x), left, right).numpy(),
                                  np.pad(x, (left, right), mode="reflect"))


# --------------------------------------------------------------- quantiles --
def test_quantiles(rng):
    x = rng.randn(200, 5).astype(np.float32)
    for q in (0.1, 0.5, 0.975):
        _close(t_q.quantile(torch.as_tensor(x), q, dim=0), jnp.quantile(jnp.asarray(x), q, axis=0), 1e-6)
        _close(t_q.quantile(torch.as_tensor(x), q), jnp.quantile(jnp.asarray(x), q), 1e-6)
    mask = rng.rand(200, 5) > 0.6
    _close(t_q.masked_quantile(torch.as_tensor(x), torch.as_tensor(mask), 0.5),
           j_q.masked_quantile(jnp.asarray(x), jnp.asarray(mask), 0.5), 1e-6)
    assert torch.isinf(t_q.masked_quantile(torch.as_tensor(x), torch.zeros(200, 5, dtype=torch.bool), 0.5))


def test_percentile_clamps(rng):
    x = rng.randn(120, 6).astype(np.float32)
    _close(t_q.clamp_peaks_percentile(torch.as_tensor(x), 97.5),
           j_q.clamp_peaks_percentile(jnp.asarray(x), 97.5), 1e-6)
    _close(t_q.clamp_peaks_percentile(torch.as_tensor(x[:, 0]), 90.0),
           j_q.clamp_peaks_percentile(jnp.asarray(x[:, 0]), 90.0), 1e-6)
    _close(t_q.clamp_lower_percentile(torch.as_tensor(x), 10.0),
           j_q.clamp_lower_percentile(jnp.asarray(x), 10.0), 1e-6)


# ----------------------------------------------------------------- upfirdn --
@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1))])
def test_upfirdn2d(rng, up, down, pad):
    x = rng.randn(2, 9, 9, 3).astype(np.float32)  # NHWC for JAX
    k = j_up.make_blur_kernel() * 4.0
    want = j_up.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad)
    got = t_up.upfirdn2d(torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(k), up=up, down=down, pad=pad)
    _close(got.permute(0, 2, 3, 1), want)


def test_fused_leaky_relu_and_upsample(rng):
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    _close(t_up.fused_leaky_relu(xt, torch.as_tensor(b)).permute(0, 2, 3, 1),
           j_up.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    _close(t_up.upsample2x(xt).permute(0, 2, 3, 1), j_up.upsample2x(jnp.asarray(x)))


# ------------------------------------------------------------- absdiff (B2) --
# float32 sums of |differences| taken in another order: rtol 1e-5, atol 1e-4
# (as tests/test_ops.py holds the Pallas kernel against absdiff_ref)
j_absdiff = importlib.import_module("ssar_tpu.ops.absdiff")
from ssar_tpu_torch.ops import absdiff as t_absdiff  # noqa: E402


@pytest.mark.parametrize("shape", [(33, 3, 8, 8), (17, 5), (2, 7), (96, 16)])
def test_absdiff_matches_jax_ref_and_pallas_interpret(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    got = t_absdiff.absdiff(torch.as_tensor(x)).numpy()
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got, np.asarray(j_absdiff.absdiff_ref(jnp.asarray(x))), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(j_absdiff.absdiff_pallas(jnp.asarray(x))), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got, t_absdiff.absdiff_plain(torch.as_tensor(x)).numpy())


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32", "float64"])
def test_absdiff_plain_every_dtype_matches_jax_ref(rng, dtype):
    """The plain version (the CPU's) keeps the input's dtype, as
    ``absdiff_ref`` does; held against JAX's in that dtype at two of its
    epsilons (sums in another order; JAX with x64 off computes float64 in
    float32)."""
    x = torch.as_tensor(rng.randn(20, 3, 16).astype(np.float32)).to(getattr(torch, dtype))
    got = t_absdiff.absdiff(x)
    assert got.dtype == x.dtype and tuple(got.shape) == (20,)
    want = np.asarray(j_absdiff.absdiff_ref(jnp.asarray(x.float().numpy()).astype(
        jnp.float32 if dtype == "float64" else getattr(jnp, dtype))).astype(jnp.float32))
    eps = float(torch.finfo(getattr(torch, dtype)).eps) if dtype != "float64" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 * eps, atol=0)


def test_batch_absdiff_matches_vmap(rng):
    x = rng.randn(3, 20, 4, 4).astype(np.float32)
    want = jax.vmap(j_absdiff.absdiff_ref)(jnp.asarray(x))
    np.testing.assert_allclose(t_absdiff.batch_absdiff(torch.as_tensor(x)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        t_absdiff.batch_absdiff(torch.zeros(2, 1, 3))


@pytest.mark.parametrize("shape", [(9, 4), (2, 6), (12, 3, 5)])
def test_absdiff_grad_matches_jax(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    w = np.arange(shape[0], dtype=np.float32)
    want = jax.grad(lambda a: jnp.sum(j_absdiff.absdiff(a) * jnp.asarray(w)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    (t_absdiff.absdiff(xt) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- S4D Vandermonde (B3) --
# rtol 1e-4, atol 1e-5, as tests/test_ops.py holds the Pallas kernel against
# the complex s4d_kernel: exp/cos/sin of the same fp32 products, summed over N
# in another order
j_vdm = importlib.import_module("ssar_tpu.ops.vandermonde")
from ssar_tpu_torch.ops import vandermonde as t_vdm  # noqa: E402


def _vdm_inputs(rng, H, N):
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (H, 1)))
    a = (-0.5 * np.ones((H, N)) * dt).astype(np.float32)
    b = (np.pi * np.arange(N)[None] * dt).astype(np.float32)
    cre = (rng.randn(H, N) * 0.3).astype(np.float32)
    cim = (rng.randn(H, N) * 0.3).astype(np.float32)
    return a, b, cre, cim


@pytest.mark.parametrize("H,N,L", [(12, 16, 100), (13, 7, 300), (4, 32, 192)])
def test_vandermonde_plain_matches_jax_ref(rng, H, N, L):
    args = _vdm_inputs(rng, H, N)
    want = np.asarray(j_vdm.s4d_vandermonde_ref(*map(jnp.asarray, args), L))
    got = t_vdm.s4d_vandermonde(*map(torch.as_tensor, args), L).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got, t_vdm.s4d_vandermonde_plain(*map(torch.as_tensor, args), L).numpy())


@pytest.mark.parametrize("H,N,L", [(8, 32, 192), (5, 7, 256)])
def test_vandermonde_matches_pallas_interpret(rng, H, N, L):
    """One grid block of the Pallas kernel (h_blk 8, l_blk 256), in interpret mode."""
    args = _vdm_inputs(rng, H, N)
    want = np.asarray(j_vdm.s4d_vandermonde_pallas(*map(jnp.asarray, args), L))
    got = t_vdm.s4d_vandermonde(*map(torch.as_tensor, args), L).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("H,N,L", [(6, 8, 50), (13, 7, 120)])
def test_vandermonde_grads_match_jax_vjp(rng, H, N, L):
    args = _vdm_inputs(rng, H, N)
    g = rng.randn(H, L).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: j_vdm.s4d_vandermonde_ref(*a, L), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    got = torch.autograd.grad(t_vdm.s4d_vandermonde(*leaves, L), leaves, torch.as_tensor(g))
    for name, gt, gw in zip(("a", "b", "cre", "cim"), got, want):
        gw = np.asarray(gw)
        np.testing.assert_allclose(gt.numpy(), gw, rtol=1e-4, atol=1e-5 * np.abs(gw).max(), err_msg=name)


def test_s4d_kernel_fused_matches_jax(rng):
    H, N, L = 12, 16, 100
    log_dt = np.log(rng.uniform(1e-3, 1e-1, H)).astype(np.float32)
    A_re = (-0.5 * np.ones((H, N))).astype(np.float32)
    A_im = (np.pi * np.arange(N)[None].repeat(H, 0)).astype(np.float32)
    C_re, C_im = (rng.randn(2, H, N) * 0.3).astype(np.float32)
    args = (log_dt, A_re, A_im, C_re, C_im)
    want = np.asarray(j_vdm.s4d_kernel_fused(*map(jnp.asarray, args), L, use_pallas=False))
    got = t_vdm.s4d_kernel_fused(*map(torch.as_tensor, args), L).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    plain = t_vdm.s4d_vandermonde_plain(*t_vdm.zoh_factors(*map(torch.as_tensor, args)), L).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-5)
