"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA card every test skips (the kernels have no CPU mode); the
CPU tests hold the plain versions against the JAX package.  The median is
compared exactly: it selects one of the window's elements.
"""
import pytest
import torch

from ssar_tpu_torch.ops.median import median_filter, median_filter_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sliding-median kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((1025, 193), 31), ((2, 1025, 300), 31), ((37, 16), 31), ((53, 77), 7),
                                     ((53, 77), 9), ((3, 5, 40), 1)])
def test_median_cuda_kernel_matches_plain(cuda_device, shape, k):
    from ssar_tpu_torch.ops import median_cuda

    x = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    before = median_cuda.launches
    for axis in (-1, -2):
        assert torch.equal(median_filter(x, k, axis), median_filter_plain(x, k, axis))
    assert median_cuda.launches == before + 2


@pytest.mark.cuda
def test_median_cuda_other_axis_and_errors(cuda_device):
    x = torch.rand(6, 5, 40, device=cuda_device)
    assert torch.equal(median_filter(x, 3, 0), median_filter_plain(x, 3, 0))
    with pytest.raises(ValueError):
        median_filter(torch.rand(4, 40, device=cuda_device), 33)   # no instantiation above 31
    with pytest.raises(ValueError):
        median_filter(torch.rand(4, 10, device=cuda_device), 31)   # reflect pad needs > k // 2 samples
    with pytest.raises(TypeError):
        median_filter(torch.rand(4, 40, device=cuda_device, dtype=torch.float64), 7)
