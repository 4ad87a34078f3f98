"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA card every test skips (the kernels have no CPU mode); the
CPU tests hold the plain versions against the JAX package.  The other model
families, the backbones and one or two steps of each trainer are held
against the same code on the CPU (float32 without TF32, the draws made on
the CPU) at 1e-4 of the largest magnitude.  The median is
compared exactly: it selects one of the window's elements, a window holding a
NaN gives NaN in both (NaNs in the same places), and a line no longer than
k // 2 keeps reflecting in both.  Its backward is
compared exactly too: the kernel gathers each input's cotangents in the order
the plain version adds them, and two launches give the same bits; the
generic kernels for odd k > 31 are held the same way.  absdiff at rtol
1e-5 (float32 sums of positive terms in another order), float16 / bfloat16
within one unit in the last place of the float32 result cast, and bit for
bit between two launches; the S4D Vandermonde kernel and its backward at rtol
1e-4 with an atol of 1e-5 of the largest magnitude (exp / sin / cos of the
same fp32 products, summed in another order).  The 2-D median helpers and
``video_absdiff`` launch B1 and B2 once a call; the extractors and pSp are
held card against CPU at 1e-4 of the largest magnitude.  Example patches
(``scrolling_drop_patch``, ``stem_separated_patch`` with stems) go through
``render_patch`` on the card and on the CPU at 32 px with the noise banks
drawn on the CPU, within 1e-3, B1's launches exact; ``set_bends`` takes a
CUDA modulation (fault C5).  The multi-rank helpers at world size 1 on an
NCCL group: ``shard_batch`` and ``replicate`` are identities and
``synthesize_tp`` on a (1, 1) mesh equals ``synthesis`` (torch.equal);
``resolve_device`` under ``torchrun``'s ``LOCAL_RANK``.  The record
corpus's ``make_targets`` on a 4 s track launches B1 exactly 8 times.
"""
import pytest
import torch

from ssar_tpu_torch.ops.absdiff import batch_absdiff, batch_absdiff_plain
from ssar_tpu_torch.ops.median import median_filter, median_filter_plain, sliding_median_bwd_plain
from ssar_tpu_torch.ops.vandermonde import s4d_vandermonde, s4d_vandermonde_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((1025, 193), 31), ((2, 1025, 300), 31), ((37, 16), 31), ((53, 77), 7),
                                     ((53, 77), 9), ((3, 5, 40), 1), ((1025, 1441), 31), ((1440, 8), 3),
                                     ((96, 8), 3)])
def test_median_cuda_kernel_matches_plain(cuda_device, shape, k):
    from ssar_tpu_torch.ops import median_cuda

    x = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    before = median_cuda.launches
    for axis in (-1, -2):
        assert torch.equal(median_filter(x, k, axis), median_filter_plain(x, k, axis))
    assert median_cuda.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,k", [((1025, 193), 31), ((2, 130, 300), 31), ((37, 16), 31), ((120, 60), 7),
                                     ((60, 60), 9), ((3, 5, 40), 1), ((5, 9), 9)])
def test_median_backward_cuda_kernel_matches_plain(cuda_device, shape, k, ties):
    """B1's backward on both axes: the kernel equals the plain version bit for
    bit, on distinct values and on quantised values with a constant row, and a
    second launch gives the same bits; ``median_filter`` launches it from
    autograd."""
    from ssar_tpu_torch.ops import median_cuda

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen)
    if ties:
        x = torch.round(x * 2) / 2
        x[..., 0, :] = 1.0
    x = x.to(cuda_device)
    g = torch.randn(shape, generator=gen).to(cuda_device)
    for axis in (-1, -2):
        leaf = x.clone().requires_grad_()
        out = median_filter(leaf, k, axis)
        before = median_cuda.bwd_launches
        (got,) = torch.autograd.grad(out, leaf, g)
        assert median_cuda.bwd_launches == before + 1
        want = sliding_median_bwd_plain(x, out.detach(), g, k, axis)
        assert torch.equal(got, want)
        assert torch.equal(median_cuda.sliding_median_bwd_cuda(x, out.detach(), g, k, axis % x.ndim), got)


def _equal_with_nans(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaNs in the same places and every other value equal."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


def _check_both_directions(x, g, k):
    """Forward and backward kernels against the plain versions on both axes;
    the backward twice."""
    from ssar_tpu_torch.ops import median_cuda

    for axis in (-1, -2):
        out = median_filter(x, k, axis)
        assert _equal_with_nans(out, median_filter_plain(x, k, axis))
        got = median_cuda.sliding_median_bwd_cuda(x, out, g, k, axis % x.ndim)
        assert torch.equal(got, sliding_median_bwd_plain(x, out, g, k, axis))
        assert torch.equal(got, median_cuda.sliding_median_bwd_cuda(x, out, g, k, axis % x.ndim))


@pytest.mark.cuda
def test_median_backward_cuda_nan_and_errors(cuda_device):
    from ssar_tpu_torch.ops import median_cuda

    x = torch.randn(6, 50, generator=torch.Generator().manual_seed(2))
    x[2, 20] = float("nan")
    x = x.to(cuda_device)
    out = median_filter(x, 7)
    assert bool(out[2, 17:24].isnan().all()) and int(out.isnan().sum()) == 7
    g = torch.ones_like(x)
    got = median_cuda.sliding_median_bwd_cuda(x, out, g, 7, 1)
    assert torch.equal(got, sliding_median_bwd_plain(x, out, g, 7, 1))
    with pytest.raises(TypeError):
        median_cuda.sliding_median_bwd_cuda(x.double(), out.double(), g.double(), 7, 1)
    with pytest.raises(ValueError):
        median_cuda.sliding_median_bwd_cuda(x, out[:, :10], g, 7, 1)
    with pytest.raises(ValueError):
        median_cuda.sliding_median_bwd_cuda(x.cpu(), out.cpu(), g.cpu(), 7, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((6, 50), 7), ((1025, 193), 31), ((3, 40, 70), 9), ((2, 3), 7), ((70, 5), 31)])
def test_median_cuda_window_with_nan(cuda_device, shape, k):
    """A window holding a NaN gives NaN (the kernel tests for it: min/max drop
    a NaN operand), and the backward routes nothing from it."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=gen)
    flat = x.view(-1)
    flat[torch.randperm(flat.numel(), generator=gen)[: max(1, flat.numel() // 300)]] = float("nan")
    g = torch.randn(shape, generator=gen).to(cuda_device)
    x = x.to(cuda_device)
    assert bool(median_filter(x, k, -1).isnan().any())
    _check_both_directions(x, g, k)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,k", [((40, 3), 7), ((5, 9), 31), ((2, 6, 1), 9), ((1, 1), 31), ((3, 4), 9),
                                     ((2, 15), 31), ((4, 10), 31)])
def test_median_cuda_short_lines(cuda_device, shape, k, ties):
    """Lines no longer than k // 2 (on one axis or both): the padding keeps
    reflecting, forward and backward, as the plain versions do."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=gen)
    if ties:
        x = torch.round(x * 2) / 2
    _check_both_directions(x.to(cuda_device), torch.randn(shape, generator=gen).to(cuda_device), k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", list(range(1, 32, 2)))
def test_median_cuda_every_width(cuda_device, k):
    """Every instantiated width at a ragged shape, both axes, both directions."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(67, 131, generator=gen).to(cuda_device)
    _check_both_directions(x, torch.randn(67, 131, generator=gen).to(cuda_device), k)


@pytest.mark.cuda
def test_median_cuda_other_axis_and_errors(cuda_device):
    x = torch.rand(6, 5, 40, device=cuda_device)
    assert torch.equal(median_filter(x, 3, 0), median_filter_plain(x, 3, 0))
    with pytest.raises(ValueError):
        median_filter(torch.rand(4, 40, device=cuda_device), 34)   # even widths have no median tap
    short = torch.rand(4, 10, device=cuda_device)                  # a pad of 15 on lines of 10 keeps reflecting
    assert torch.equal(median_filter(short, 31), median_filter_plain(short, 31))
    wide = torch.rand(4, 40, device=cuda_device, dtype=torch.float64)  # float64 runs the kernel in float32
    assert torch.equal(median_filter(wide, 7), median_filter_plain(wide.float(), 7).double())


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,k", [((67, 131), 33), ((40, 100), 63), ((2, 30, 50), 33), ((5, 9), 33),
                                     ((1025, 193), 127), ((200, 90), 255), ((40, 600), 545), ((6, 4200), 4097),
                                     ((2, 9000), 8161), ((2, 13000), 12001)])
def test_median_cuda_generic_width(cuda_device, shape, k, ties):
    """The generic kernels (odd k > 31) on both axes and in both directions,
    bit for bit, counted apart from the templated kernels: forward tiles of
    8 lines within 48 KB of shared memory (k = 33 to 255) and above it (545),
    of 4 lines (4097), 2 lines (8161) and one line (12001)."""
    from ssar_tpu_torch.ops import median_cuda

    gen = torch.Generator().manual_seed(k)
    x = torch.randn(shape, generator=gen)
    if ties:
        x = torch.round(x * 2) / 2
    before = (median_cuda.launches, median_cuda.generic_launches, median_cuda.generic_bwd_launches)
    _check_both_directions(x.to(cuda_device), torch.randn(shape, generator=gen).to(cuda_device), k)
    after = (median_cuda.launches, median_cuda.generic_launches, median_cuda.generic_bwd_launches)
    assert after[0] == before[0] and after[1] > before[1] and after[2] > before[2]


@pytest.mark.cuda
def test_median_cuda_generic_refuses_wider_than_its_tile(cuda_device):
    """A window wider than a one-line tile fits the card's shared memory
    raises; it never falls back to the plain version."""
    from ssar_tpu_torch.ops import median_cuda

    x = torch.rand(2, 40, device=cuda_device)
    with pytest.raises(RuntimeError):
        median_cuda.sliding_median_cuda(x, 16417, 1)
    with pytest.raises(RuntimeError):
        median_cuda.sliding_median_bwd_cuda(x, x, x, 14417, 1)
    out = median_cuda.sliding_median_cuda(x, 16415, 1)
    assert torch.equal(out, median_filter_plain(x, 16415, 1))
    median_cuda.sliding_median_bwd_cuda(x, out, x, 14415, 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_median_cuda_half_dtypes(cuda_device, dtype):
    """Half dtypes make an exact float32 round trip through the kernels."""
    from ssar_tpu_torch.ops import median_cuda

    x = torch.randn(64, 300, generator=torch.Generator().manual_seed(2)).to(cuda_device, dtype)
    before = median_cuda.launches
    for axis in (-1, -2):
        got = median_filter(x, 31, axis)
        assert got.dtype == dtype and torch.equal(got, median_filter_plain(x.float(), 31, axis).to(dtype))
    assert median_cuda.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 192, 9216), (2, 192, 16), (3, 33, 7), (5, 2, 100), (1, 9, 1),
                                   (1, 1440, 3 * 256 * 256), (1, 96, 3 * 64 * 64), (1, 192, 3 * 1024 * 1024),
                                   (1, 192, 3 * 1024 * 1024 + 3), (4, 48, 3 * 512 * 512), (2, 40, 99999)])
def test_absdiff_cuda_kernel_matches_plain(cuda_device, shape):
    """float32 at rtol 1e-5, two launches bit for bit, one launch a call,
    whatever the plan: one block a chunk, the element axis split across
    blocks (the long rows), the scalar route (ragged and odd E)."""
    from ssar_tpu_torch.ops import absdiff_cuda

    x = torch.randn(shape, generator=torch.Generator(device=cuda_device).manual_seed(1), device=cuda_device)
    before = absdiff_cuda.launches
    got = batch_absdiff(x)
    again = batch_absdiff(x)
    assert absdiff_cuda.launches == before + 2
    torch.testing.assert_close(got, batch_absdiff_plain(x), rtol=1e-5, atol=0)
    assert torch.equal(got, again)
    with pytest.raises(TypeError):
        absdiff_cuda.batch_absdiff_cuda(x[:1, :3].int())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 192, 1024), (32, 192, 9216), (1, 192, 3 * 1024 * 1024), (2, 40, 99999)])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float64])
def test_absdiff_cuda_other_dtypes(cuda_device, dtype, shape):
    """float16 and bfloat16 are read as they are: one launch, the result in
    the dtype within one unit in its last place of the float32 plain result
    cast, two launches bit for bit.  float64 goes through the float32 kernel
    and comes back: equal to the float32 kernel's result cast."""
    from ssar_tpu_torch.ops import absdiff_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    before = absdiff_cuda.launches
    got = batch_absdiff(x)
    assert absdiff_cuda.launches == before + 1 and got.dtype == dtype
    if dtype == torch.float64:
        assert torch.equal(got, absdiff_cuda.batch_absdiff_cuda(x.float()).to(dtype))
    else:
        # float16 sums over 3 x 1024 x 1024 elements overflow to inf in both
        want = batch_absdiff_plain(x.float()).to(dtype).float()
        torch.testing.assert_close(got.float(), want, rtol=torch.finfo(dtype).eps, atol=0)
        assert torch.equal(got, batch_absdiff(x))


def _s4d_inputs(H: int, N: int, device):
    """The four (H, N) Vandermonde inputs of a freshly initialised S4D layer."""
    from ssar_tpu_torch.models.s4 import S4DLayer
    from ssar_tpu_torch.ops.vandermonde import zoh_factors

    torch.manual_seed(H * 1000 + N)
    layer = S4DLayer(H, 2 * N).to(device)
    with torch.no_grad():
        return [t.contiguous() for t in zoh_factors(layer.log_dt, layer._A_re(), layer.A_im, layer.C_re,
                                                    layer.C_im)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,N,L", [(104, 32, 192), (32, 32, 192), (104, 64, 4320), (13, 7, 1000), (3, 1, 5),
                                   (3, 2000, 70)])
def test_vandermonde_cuda_kernels_match_plain(cuda_device, H, N, L):
    from ssar_tpu_torch.ops import vandermonde_cuda

    leaves = [t.requires_grad_() for t in _s4d_inputs(H, N, cuda_device)]
    g = torch.randn(H, L, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    fwd, bwd = vandermonde_cuda.launches, vandermonde_cuda.bwd_launches
    K = s4d_vandermonde(*leaves, L)
    got = torch.autograd.grad(K, leaves, g)
    assert (vandermonde_cuda.launches, vandermonde_cuda.bwd_launches) == (fwd + 1, bwd + 1)
    K_plain = s4d_vandermonde_plain(*leaves, L)
    want = torch.autograd.grad(K_plain, leaves, g)
    K, K_plain = K.detach(), K_plain.detach()
    torch.testing.assert_close(K, K_plain, rtol=1e-4, atol=1e-5 * float(K_plain.abs().max()))
    for name, a, b in zip(("a", "b", "cre", "cim"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()), msg=name)
    args = [t.detach() for t in leaves]  # two launches give the same bits
    assert torch.equal(vandermonde_cuda.s4d_vandermonde_cuda(*args, L), K)
    assert all(torch.equal(x, y) for x, y in zip(vandermonde_cuda.s4d_vandermonde_bwd_cuda(*args, g), got))


@pytest.mark.cuda
def test_vandermonde_cuda_rejects_what_it_does_not_take(cuda_device):
    from ssar_tpu_torch.ops import vandermonde_cuda

    a = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(TypeError):
        vandermonde_cuda.s4d_vandermonde_cuda(a.double(), a.double(), a.double(), a.double(), 10)
    with pytest.raises(ValueError):
        vandermonde_cuda.s4d_vandermonde_cuda(a, a, a, a[:2], 10)
    with pytest.raises(ValueError):
        vandermonde_cuda.s4d_vandermonde_cuda(a, a, a, a, 0)


@pytest.mark.cuda
def test_keys_draw_noise_banks_on_the_card(cuda_device):
    """The patch system's banks are drawn on the card from the card's
    generator: they land there, and one key gives one bank; the structure
    draws (a scalar normal) stay on the CPU."""
    from ssar_tpu_torch.generate import keys

    key = keys.split(keys.PRNGKey(42))[1]
    a, b = keys.normal(key, (2, 20, 64, 64), device=cuda_device), keys.normal(key, (2, 20, 64, 64), device=cuda_device)
    assert a.device.type == "cuda" and a.dtype == torch.float32 and torch.equal(a, b)
    assert abs(float(a.mean())) < 0.01 and abs(float(a.std()) - 1) < 0.01
    assert not torch.equal(a, keys.normal(keys.split(key)[0], (2, 20, 64, 64), device=cuda_device))
    assert keys.normal(key).device.type == "cpu"


@pytest.mark.cuda
def test_video_features_run_the_kernels_on_the_card(cuda_device):
    """``directogram`` filters with B1 (k = 3, both axes: two launches) and
    the ``absdiff`` feature is one B2 launch; both equal the same function on
    the CPU."""
    from ssar_tpu_torch.ops import absdiff_cuda, median_cuda
    from ssar_tpu_torch.video import features

    gen = torch.Generator().manual_seed(2)
    flow = torch.rand(96, 2, 64, 64, generator=gen)
    video = torch.rand(96, 3, 64, 64, generator=gen)
    b1, b2 = median_cuda.launches, absdiff_cuda.launches
    dg = features.directogram(flow.to(cuda_device))
    ad = features.absdiff(video.to(cuda_device))
    assert (median_cuda.launches - b1, absdiff_cuda.launches - b2) == (2, 1)
    assert torch.equal(dg.cpu(), features.directogram(flow))
    torch.testing.assert_close(ad.cpu(), features.absdiff(video), rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_evaluate_reactivity_on_the_card(cuda_device):
    """The evaluation at a small size on the card: two HPSS (four B1
    launches) and one B2 launch, and the CPU's scores within 1e-3."""
    import numpy as np

    from ssar_tpu_torch.metrics.sectional import evaluate_reactivity
    from ssar_tpu_torch.ops import absdiff_cuda, median_cuda

    sr, fps = 24576, 24
    rng = np.random.RandomState(0)
    t = np.arange(4 * sr) / sr   # a track whose tuning estimate has a wide margin (chip_smoke.two_part_track)
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < 2, 220.0, 330.0)) / sr)
             + np.where(t < 2, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    video = rng.rand(96, 3, 32, 32).astype(np.float32)
    video[::12] = 1.0
    b1, b2 = median_cuda.launches, absdiff_cuda.launches
    card = evaluate_reactivity(audio, sr, video, fps, device=cuda_device)
    assert (median_cuda.launches - b1, absdiff_cuda.launches - b2) == (4, 1)
    cpu = evaluate_reactivity(audio, sr, video, fps, device="cpu")
    for k in ("rhythmic", "chromatic"):
        assert abs(card[k] - cpu[k]) <= 1e-3, (k, card[k], cpu[k])


# ----------------------------------------------- the other models and trainers --
def _card_vs_cpu(make, inputs, device, rtol=1e-4):
    """A model built on the CPU and its copy on the card, the same inputs,
    float32 without TF32: outputs within rtol of their largest magnitude."""
    import copy

    from ssar_tpu_torch.utils.device import full_precision

    cpu = make().eval()
    card = copy.deepcopy(cpu).to(device)
    with torch.no_grad(), full_precision():
        want = cpu(*inputs)
        got = card(*(x.to(device) if torch.is_tensor(x) else x for x in inputs))
    for g, w in zip(got if isinstance(got, (tuple, list)) else [got], want if isinstance(want, (tuple, list)) else [want]):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= rtol * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gru", "lstm", "conv", "mlp", "transformer", "sashimi"])
def test_backbones_on_the_card_match_the_cpu(cuda_device, name):
    from ssar_tpu_torch.models.backbones import make_backbone

    torch.manual_seed(0)
    x = torch.randn(4, 48, 16)
    _card_vs_cpu(lambda: make_backbone(name, 16, 2)[0], (x,), cuda_device)


@pytest.mark.cuda
def test_model_families_on_the_card_match_the_cpu(cuda_device):
    import numpy as np

    from ssar_tpu_torch.gan.discriminator import Discriminator, PSPEncoder
    from ssar_tpu_torch.models.audio2latent import Audio2Latent, Audio2Latent2
    from ssar_tpu_torch.models.psagan import ProgressiveDiscriminator
    from ssar_tpu_torch.models.reactor import ConvNoiseUpsampler
    from ssar_tpu_torch.models.selfsupervised import LSTMReactor, StyleVideoDiscriminator, StyleVideoGenerator

    torch.manual_seed(0)
    f = torch.randn(2, 32, 12)
    mean, std = np.zeros(12, np.float32), np.ones(12, np.float32)
    for backbone in ("gru", "lstm", "conv"):
        _card_vs_cpu(lambda: Audio2Latent(mean, std, hidden_size=8, num_layers=2, backbone=backbone), (f,),
                     cuda_device)
    _card_vs_cpu(lambda: Audio2Latent2(mean, std, hidden_size=8, context="transformer"), (f,), cuda_device)
    _card_vs_cpu(lambda: ConvNoiseUpsampler(12, 12), (f,), cuda_device)
    _card_vs_cpu(lambda: ProgressiveDiscriminator(16, 12, 8, 3), (torch.randn(2, 32, 16), f), cuda_device)
    _card_vs_cpu(lambda: StyleVideoGenerator(2, 8), (torch.randn(2, 6, 8),), cuda_device)
    _card_vs_cpu(lambda: StyleVideoDiscriminator(6, 2, 8), (torch.randn(2, 6, 2, 512),), cuda_device)
    _card_vs_cpu(lambda: LSTMReactor(12, 6, 2, 2), (f, torch.randn(2, 6)), cuda_device)
    img = torch.randn(4, 16, 16, 3)
    _card_vs_cpu(lambda: Discriminator(16, 1), (img,), cuda_device)
    _card_vs_cpu(lambda: PSPEncoder(4, 16), (img,), cuda_device)


@pytest.mark.cuda
def test_sashimi_launches_b3_forward_and_backward(cuda_device):
    """10 S4 blocks (2 a tier, 2 tiers: down and up, and the centre's 2): one
    B3 forward and one backward each per forward and backward."""
    from ssar_tpu_torch.models.sashimi import Sashimi
    from ssar_tpu_torch.ops import vandermonde_cuda

    model = Sashimi(16).to(cuda_device)
    x = torch.randn(2, 64, 16, device=cuda_device)
    before = (vandermonde_cuda.launches, vandermonde_cuda.bwd_launches)
    model(x).square().mean().backward()
    assert (vandermonde_cuda.launches - before[0], vandermonde_cuda.bwd_launches - before[1]) == (10, 10)


@pytest.fixture
def cpu_draws(monkeypatch):
    """``keys.normal`` draws on the CPU and moves the result: a card and the
    CPU get the same noise (each device's own stream differs otherwise)."""
    from ssar_tpu_torch.generate import keys

    normal = keys.normal
    monkeypatch.setattr(keys, "normal", lambda key, shape=(), device=None: normal(key, shape).to(device or "cpu"))


@pytest.mark.cuda
def test_psagan_generator_on_the_card_matches_the_cpu(cuda_device, cpu_draws):
    from ssar_tpu_torch.models.psagan import ProgressiveGenerator

    torch.manual_seed(0)
    _card_vs_cpu(lambda: ProgressiveGenerator(12, 16, 8, 3), (torch.randn(2, 32, 12), (0, 5)), cuda_device)


@pytest.mark.cuda
def test_trainer_steps_on_the_card_match_the_cpu(cuda_device, cpu_draws):
    """Two steps of each trainer from the same seed, data and draws, float32
    without TF32 (the calibration G's synthesis too): the losses agree."""
    import numpy as np

    from ssar_tpu_torch.gan import stylegan2 as sg
    from ssar_tpu_torch.train import palette_g, trainers
    from ssar_tpu_torch.train.data import synthetic_dataset
    from ssar_tpu_torch.utils.device import full_precision

    ds = synthetic_dataset(n_windows=4, n_frames=16, seed=3)
    wplus = np.random.RandomState(4).randn(4, 6, 2, 512).astype(np.float32) * 0.1
    cfg = sg.StyleGAN2Config(resolution=16, max_channels=16)
    init = sg.init_generator(cfg, torch.Generator().manual_seed(0))
    runs = {
        "a2l": lambda d: trainers.train_audio2latent(ds, n_steps=2, batch_size=2, hidden_size=8, device=d)[1],
        "psagan": lambda d: trainers.train_psagan(ds, n_steps=2, batch_size=2, features=8, n_stages=2,
                                                  device=d)[1],
        "stylevideogan": lambda d: trainers.train_stylevideogan(wplus, n_steps=2, batch_size=2, latent_dim=8,
                                                                device=d)[1],
        "sslstm": lambda d: trainers.train_sslstm(ds, n_steps=2, batch_size=2, hidden_size=6, n_patches=4,
                                                  patch_len=4, device=d)[1],
        "calibration": lambda d: palette_g.train_calibration_g(cfg, n_steps=2, batch_size=2, progress=False,
                                                               device=d, params=init, dtype=torch.float32)[2],
    }
    with full_precision():
        for name, run in runs.items():
            cpu, card = run("cpu"), run(cuda_device)
            for k, want in cpu.items():
                if isinstance(want, list):
                    got = np.asarray(card[k])
                    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(np.asarray(want)) + 1e-6), (name, k, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sigma", [((192, 59), 2.0), ((1440, 12), 20.0), ((96, 3, 16, 16), 5.0),
                                         ((48, 1, 64, 64), 3.0)])
def test_gaussian_filter_runs_in_full_float32_with_tf32_allowed(cuda_device, shape, sigma):
    """Fault C4: with TF32 explicitly allowed for cuDNN, ``gaussian_filter`` on
    the card stays within 1e-6 of float64 on the CPU, relative to the largest
    output (TF32 keeps ~3 digits), and leaves the flag as it found it."""
    from ssar_tpu_torch.ops.gaussian import gaussian_filter

    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    want = gaussian_filter(x.double(), sigma)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = gaussian_filter(x.to(cuda_device), sigma)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    err = float((got.cpu().double() - want).abs().max() / want.abs().max())
    assert got.dtype == torch.float32 and err <= 1e-6, err


@pytest.mark.cuda
def test_raw_cache_batches_and_checkpoint_on_the_card(cuda_device, tmp_path):
    """The raw streaming cache feeds the trainer on the card, and a run's
    checkpoint loads back to the same outputs as the model it holds."""
    import numpy as np

    from ssar_tpu_torch.train import data, evaluate, train

    rng = np.random.RandomState(0)
    T = 120
    for split in ("train", "val"):
        data.write_raw_cache(tmp_path / "cache", split, rng.randn(T, 59), rng.randn(T, 18, 512),
                             [rng.randn(T, s, s) for s in (4, 8, 16, 32)], 48, [T])
    np.save(tmp_path / "cache" / "train_mean.npy", np.zeros(59, np.float32))
    np.save(tmp_path / "cache" / "train_std.npy", np.ones(59, np.float32))
    flags = ["--decoder", "fixed", "--backbone", "sashimi", "--loss", "ssabsdiff", "--hidden_size", "4",
             "--num_layers", "1", "--duration", "2", "--batch_size", "4", "--n_examples", "8", "--no-render_at_ckpt",
             "--no-fcd", "--cache_dir", str(tmp_path / "cache"), "--out_dir", str(tmp_path / "runs")]
    log_dir, val = train.main(flags)
    assert np.isfinite(val)
    model, _ = evaluate.load_checkpoint(str(log_dir), device=cuda_device)
    x = torch.randn(2, 48, 59, device=cuda_device)
    a, _ = model(x, generator=torch.Generator(cuda_device).manual_seed(1))
    b, _ = model(x, generator=torch.Generator(cuda_device).manual_seed(1))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


@pytest.mark.cuda
def test_median_filter2d_and_video_absdiff_launch_the_kernels(cuda_device):
    """The 2-D median helpers launch B1 once each and ``video_absdiff`` B2 once,
    equal to their plain versions; the wrappers never take the plain route on
    a CUDA tensor (a kernel that fails to launch raises)."""
    from ssar_tpu_torch.ops import absdiff_cuda, median_cuda
    from ssar_tpu_torch.ops.absdiff import absdiff_plain, video_absdiff
    from ssar_tpu_torch.ops.median import median_filter2d_freq, median_filter2d_time

    g = torch.Generator().manual_seed(0)
    S = torch.rand(1025, 301, generator=g).to(cuda_device)
    before = median_cuda.launches
    assert torch.equal(median_filter2d_freq(S), median_filter_plain(S, 31, 0))
    assert torch.equal(median_filter2d_time(S, 7), median_filter_plain(S, 7, 1))
    assert median_cuda.launches == before + 2
    video = torch.rand(48, 3, 64, 64, generator=g).to(cuda_device)
    before = absdiff_cuda.launches
    got = video_absdiff(video)
    assert got.shape == (48, 1) and absdiff_cuda.launches == before + 1
    want = absdiff_plain(video)
    assert bool(((got[:, 0] - want).abs() <= 1e-5 * want.abs()).all())


@pytest.mark.cuda
def test_extractors_and_psp_on_the_card_match_the_cpu(cuda_device):
    """ResNet-50 (narrow), SlowFast R50 at a tiny config, a small IR-SE pSp
    encoder, VGGish and SlowFastVideo: card against CPU with the same weights,
    in full float32, within 1e-4 of the largest magnitude."""
    import copy

    from ssar_tpu_torch.gan import psp
    from ssar_tpu_torch.models import extractors, resnet, slowfast_r50

    g = torch.Generator().manual_seed(0)

    def held(card, cpu):
        card, cpu = card.detach().cpu(), cpu.detach()
        assert card.shape == cpu.shape
        assert float((card - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())

    r = resnet.init_random_params(widths=(8, 16, 16, 32))
    x = torch.rand(2, 48, 48, 3, generator=g)
    held(resnet.resnet50_features(copy.deepcopy(r).to(cuda_device), x.to(cuda_device)), resnet.resnet50_features(r, x))

    tiny = slowfast_r50.SlowFastConfig(beta_inv=4, width=8, depths=(1, 1, 1, 1), fusion_kernel=3)
    sf = slowfast_r50.init_random_params(0, tiny)
    fast = torch.rand(2, 3, 8, 32, 32, generator=g)
    for a, b in zip(slowfast_r50.slowfast_features(copy.deepcopy(sf).to(cuda_device), fast[:, :, ::4].to(cuda_device),
                                                   fast.to(cuda_device)),
                    slowfast_r50.slowfast_features(sf, fast[:, :, ::4], fast)):
        held(a, b)

    enc = psp.init_random_params(0, ((8, 8, 1), (8, 12, 1), (12, 16, 1), (16, 24, 1)), 8, 32, 16)
    imgs = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    held(psp.gradual_style_encoder(copy.deepcopy(enc).to(cuda_device), imgs.to(cuda_device)),
         psp.gradual_style_encoder(enc, imgs))
    w_card = psp.invert_frames({"encoder": copy.deepcopy(enc)}, imgs, batch_size=1, device=cuda_device)
    held(w_card, psp.invert_frames({"encoder": enc}, imgs, batch_size=2, device="cpu"))

    audio = torch.randn(32000, generator=g).numpy() * 0.3
    vgg = extractors.random_vggish(0)
    held(extractors.VggishExtractor(copy.deepcopy(vgg), device=cuda_device)(audio, 16000),
         extractors.VggishExtractor(vgg, device="cpu")(audio, 16000))
    sfv = extractors.random_slowfast_video(0)
    video = torch.rand(32, 3, 32, 32, generator=g)
    held(extractors.SlowFastExtractor(copy.deepcopy(sfv), device=cuda_device)(video),
         extractors.SlowFastExtractor(sfv, device="cpu")(video))


# ----------------------------------------------------------- example patches --
def _example_synths(device, resolution: int = 32):
    """A small float32 StyleGAN2 (noise weights 0.5) on the CPU and its copy on
    the card, and a 12-latent palette from its mapping network."""
    import chip_smoke
    from ssar_tpu_torch.gan import stylegan2 as sg
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer

    cfg = sg.StyleGAN2Config(resolution=resolution, max_channels=16)
    params = sg.init_generator(cfg, torch.Generator().manual_seed(0))
    for layer in [params["conv1"], *params["convs"]]:
        layer["noise_weight"] = torch.tensor(0.5)
    syn_cpu = StyleGAN2Synthesizer(config=cfg, dtype=torch.float32, device="cpu", params=params)
    syn_card = StyleGAN2Synthesizer(config=cfg, dtype=torch.float32, device=device,
                                    params=chip_smoke._to(params, device))
    with torch.no_grad():
        palette = sg.w_to_wplus(sg.mapping(params, torch.randn(12, 512, generator=torch.Generator().manual_seed(1)),
                                           cfg), cfg)
    return syn_cpu, syn_card, palette


@pytest.mark.cuda
def test_set_bends_takes_a_cuda_modulation(cuda_device):
    """C5: an animated bend's modulation given as a CUDA tensor, also one that
    requires grad, renders what the numpy modulation renders."""
    import numpy as np

    from ssar_tpu_torch import examples
    from ssar_tpu_torch.generate import audioreactive as ar

    _, syn, _ = _example_synths(cuda_device)
    scroll = ar.load_patch_module(examples.path("scrolling_drop_patch")).scroll
    frac = np.linspace(0, 0.9, 48).astype(np.float32)
    lat = torch.randn(2, syn.config.n_latent, 512, generator=torch.Generator().manual_seed(2))
    fi = torch.tensor([10, 40])
    syn.set_bends([{"layer": 2, "transform": scroll, "modulation": frac}])
    want = syn(lat, frame_idx=fi)
    on_card = torch.as_tensor(frac, device=cuda_device)
    for given in (on_card, on_card.clone().requires_grad_()):
        syn.set_bends([{"layer": 2, "transform": scroll, "modulation": given}])
        assert torch.equal(syn(lat, frame_idx=fi), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,stems", [("scrolling_drop_patch", False), ("stem_separated_patch", True)])
def test_example_patch_on_the_card_matches_the_cpu(cuda_device, cpu_draws, tmp_path, name, stems):
    """An example through render_patch at 32 px, card against CPU with the
    banks drawn on the CPU (chip_smoke.example_card_vs_cpu: B1's launches on
    the card exactly chip_smoke.EXAMPLE_B1's): latents and noise within 1e-3
    of the largest value, bent frames within 1e-3, the scroll's per-frame
    shift equal; the stem patch with stems written to tmp_path at twice the
    mix's rate."""
    import chip_smoke

    sr = 1024 * 12
    syn_cpu, syn_card, palette = _example_synths(cuda_device)
    audio_file = None
    if stems:
        audio_file = chip_smoke.write_stems(tmp_path / "mix.wav", chip_smoke.two_part_track(2 * sr), 2 * sr)
    with torch.no_grad():
        errs = chip_smoke.example_card_vs_cpu(name, cuda_device, chip_smoke.two_part_track(sr), sr, 12, palette,
                                              syn_cpu, syn_card, audio_file)
    assert errs["latents"] <= 1e-3 and errs["noise"] <= 1e-3, errs
    if name == "scrolling_drop_patch":
        assert errs["frames"] <= 1e-3 and errs["shift_equal"] is True, errs


@pytest.fixture
def nccl_world_of_one(cuda_device, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_helpers_and_synthesize_tp_at_world_size_one(nccl_world_of_one):
    from torch.distributed.device_mesh import DeviceMesh

    from ssar_tpu_torch.gan import stylegan2 as sg
    from ssar_tpu_torch.parallel import get_mesh, make_mesh, replicate, shard_batch, synthesize_tp

    dev = nccl_world_of_one
    mesh = get_mesh()
    assert isinstance(mesh, DeviceMesh) and mesh.size() == 1 and mesh.device_type == "cuda"
    x = torch.arange(12.0, device=dev).reshape(4, 3)
    tree = {"a": x, "b": [x]}
    assert shard_batch(x, mesh) is x and replicate(tree, mesh) is tree
    config = sg.StyleGAN2Config(resolution=64)
    params = sg.init_generator(config, torch.Generator().manual_seed(0), device=dev)
    lat = torch.randn((4, config.n_latent, 512), generator=torch.Generator().manual_seed(1)).to(dev)
    grid = make_mesh((1, 1), ("data", "tp"))
    assert isinstance(grid, DeviceMesh)
    got = synthesize_tp(params, lat, None, config, grid)
    with torch.no_grad():
        want = sg.synthesis(params, lat, None, config, dtype=torch.bfloat16)
    assert got.shape == (4, 64, 64, 3) and torch.equal(got, want)


@pytest.mark.cuda
def test_resolve_device_under_torchrun(cuda_device, monkeypatch):
    from ssar_tpu_torch.utils.device import resolve_device

    monkeypatch.setenv("LOCAL_RANK", "0")
    assert resolve_device() == torch.device("cuda", 0) and torch.cuda.current_device() == 0
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device() == torch.device("cuda")


@pytest.mark.cuda
def test_make_targets_on_the_card_launches_b1_eight_times(cuda_device):
    """The record corpus's targets for a 4 s track on the card: one
    ``retrieve_music_information``, four HPSS of two filters each (B1
    exactly 8); latents (T, 18, 512) and the four noise levels finite."""
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Mapper
    from ssar_tpu_torch.ops import median_cuda
    from ssar_tpu_torch.scripts.make_record_dataset import FPS, make_targets, synth_track

    z = torch.randn(24, 512, generator=torch.Generator().manual_seed(42))
    palette = StyleGAN2Mapper(seed=0, device=cuda_device)(z)
    before = median_cuda.launches
    latents, noises = make_targets(synth_track(1000, seconds=4), 1000, palette)
    assert median_cuda.launches - before == 8
    T = 4 * FPS
    assert latents.shape == (T, 18, 512) and [n.shape for n in noises] == [(T, s, s) for s in (4, 8, 16, 32)]
    assert all(bool(torch.isfinite(torch.as_tensor(a)).all()) for a in [latents, *noises])
